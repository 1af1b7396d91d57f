"""Entry points: the probe's forward, as ``__graft_entry__.entry()`` gives
it, and the training checks of the reference's dryrun, dense
(``train_check``), MoE (``moe_check``) and sharded over a mesh of ranks:
dp x tp and expert parallelism (``tp_train_check``), dp x sp with ring
attention and the pipelines (``seq_pipeline_check``), all of them with the
stretch over an H100 topology plan (``dryrun_multichip``); the
hot-add that grows a job's mesh (``grow_check``); the control plane's
one-node hot-mount of a GPU into a pod (``mount_check``), through the
master (``master_check``), the master's slice and batch routes over a fleet
of nodes (``slice_check``), the cgroup v2 device controller on this
host's GPU (``cgroup_v2_check``), the trace, audit and failpoint core
(``obs_check``), the worker's durability: its ledger, the replay after a
death, the drain, the fence and the reaper (``durability_check``), and the
master's store through an API outage: ApiHealth, the bounded-staleness
cache, the write-behind queue and the worker's deferred releases
(``degraded_check``), sharded masters and the warm pool
(``shard_pool_check``), and the fleet planes: the collector over
CollectTelemetry and its scrape fallback, the SLOs, the tenants' telemetry
through the worker's ops port and the trace assembly under the read scope
(``fleet_check``), and health and recovery: the operator's quarantine
riding the pull to the warm pool, the canary over ProbeGPU, the scorer's
quarantine and rehabilitation, and a worker's death evacuated by the
recovery controller (``health_check``), and the elastic controller and the
live migration: an intent converged and healed over ProbeGPU, a tenant
moved between pods with its state packed and restored, and a rollback
(``elastic_migrate_check``), and the capacity plane with a metered share of
a GPU: the inventory through CollectTelemetry, a share booked, mounted with
its policy and released, a refusal's verdict (``capacity_share_check``),
the autoscaler: a tenant's curve fitted from its published steps, the
decisions its rule gives on a held GPU, the pause and the resume
(``autoscale_check``), and the operator's CLI: each verb a process against
the live stack (``cli_check``)."""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import secrets
import shutil
import signal
import stat as statmod
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import torch
import torch.distributed as dist

from gpumounter_tpu_torch._device import resolve_device
from gpumounter_tpu_torch.cgroup import ebpf
from gpumounter_tpu_torch.cgroup.policy import interpret_device_program
from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.device.backend import NvidiaDeviceBackend, identity_from_config
from gpumounter_tpu_torch.device.gpu import CompanionNode, GpuDevice
from gpumounter_tpu_torch.faults import failpoints
from gpumounter_tpu_torch.k8s import health as k8s_health
from gpumounter_tpu_torch.k8s.errors import PartitionError
from gpumounter_tpu_torch.k8s.types import Pod
from gpumounter_tpu_torch.master.app import FORWARDED_HEADER, MasterApp, build_http_server
from gpumounter_tpu_torch.master.shard import ShardManager
from gpumounter_tpu_torch.models.probe import (TransformerConfig, _attend, _block, _embed,
                                               _finish_block, _rmsnorm, forward, init_params,
                                               local_heads, loss_fn, next_token_nll)
from gpumounter_tpu_torch.obs import assembly, audit, flight, trace
from gpumounter_tpu_torch.obs.fleet import FleetCollector, worker_telemetry_snapshot
from gpumounter_tpu_torch.ops.flash_attention import attention_plain, flash_attention
from gpumounter_tpu_torch.ops.launches import TRAINING, launch_counts, reset_launch_counts
from gpumounter_tpu_torch.parallel.collectives import all_gather
from gpumounter_tpu_torch.parallel.launch import run_ranks
from gpumounter_tpu_torch.parallel.mesh import build_mesh, shard_qkv
from gpumounter_tpu_torch.parallel.moe import (_route, init_moe_params, make_moe_step,
                                               shard_moe_params)
from gpumounter_tpu_torch.parallel.pipeline import (pipeline_apply, schedule_info,
                                                    shard_stage_params)
from gpumounter_tpu_torch.parallel.pipeline_train import (make_pipeline_train_step,
                                                          shard_pipeline_params,
                                                          to_pipeline_params)
from gpumounter_tpu_torch.parallel.ring_attention import reference_attention, ring_attention
from gpumounter_tpu_torch.parallel.train_step import (gather_params, loss_and_grads,
                                                      make_train_step, make_train_step_optim,
                                                      param_specs, shard_params,
                                                      step_collectives, tree_leaves, tree_map,
                                                      tree_names)
from gpumounter_tpu_torch.rpc.api import (AddGPURequest, AddGPUResponse, AddGPUResult,
                                          RemoveGPURequest, RemoveGPUResponse,
                                          RemoveGPUResult)
from gpumounter_tpu_torch.rpc.client import WorkerClient
from gpumounter_tpu_torch.rpc.resilience import RPC_RETRIES
from gpumounter_tpu_torch.store.cache import DEFERRED_WRITES, STALE_READS
from gpumounter_tpu_torch.store.writebehind import QUEUE_FILE, WRITEBEHIND_REPLAYED, WriteBehindQueue
from gpumounter_tpu_torch.testing import v2tenant
from gpumounter_tpu_torch.testing.bpf import FakeBpf
from gpumounter_tpu_torch.testing.cluster import FakeCluster, WorkerServers
from gpumounter_tpu_torch.testing.kube_api import FakeApiServer, selfsigned
from gpumounter_tpu_torch.testing.worker_process import WorkerProcess
from gpumounter_tpu_torch.topology import lookup
from gpumounter_tpu_torch.torchside.resume import (HotResumable, load_optimizer_state,
                                                   optimizer_state_specs, optimizer_state_tree)
from gpumounter_tpu_torch.utils.fanout import FANOUT_TASKS
from gpumounter_tpu_torch.utils.metrics import MOUNT_ROLLBACK_FAILURES
from gpumounter_tpu_torch.vchip import Share
from gpumounter_tpu_torch.worker.ledger import LEDGER_APPENDS, MountLedger
from gpumounter_tpu_torch.worker.reaper import SlaveReaper
from gpumounter_tpu_torch.worker.main import serve_ops
from gpumounter_tpu_torch.worker.server import (FENCED_WRITES, SLAVE_RELEASE_DEFERRED,
                                                ServiceError, build_server)

TRAIN_GRAD_ATOL = 5e-3  # the reference's kernel-vs-xla grad limit
# The dryrun's limits: a sharded first-step loss against the unsharded loss
# (__graft_entry__.py:221-224, 333-336), ring attention against the
# one-process oracle (:241-243, :253-255).
SHARDED_LOSS_ATOL = 1e-2
RING_TOL = dict(rtol=5e-2, atol=5e-2)
# Top-1 routing is discontinuous: a token whose two best router logits are
# closer than the two runs' logits differ may go to another expert in each,
# which changes its output wholly. The kernel and the plain attention
# differ by about a bf16 ulp, which moved router logits by at most 0.019
# at the full-width MoE config on an H100 (0.1-0.3% of tokens flipped, all
# with gaps below 0.005); a token whose top-1/top-2 gap exceeds this δ must
# route the same in both runs.
MOE_ROUTE_GAP = 0.05
# A sharded SGD step against the one-process step on the same card, weights
# and tokens. Each new weight is p − lr·g rounded to bf16. g differs by a
# few bf16 ulps (g sums wo's and w2's bf16 partial products where one
# matmul rounds once, and the data shards' bf16 grads are summed in bf16),
# lr·g is far below an ulp of p, but the rounding can land on p's
# neighbour: each leaf within 1 bf16 ulp of its max |value| (2^-7 of it).
# An AdamW update is about lr whatever g, so ``grow_restore`` holds one to
# this limit only with the same gradients on both sides.
SHARDED_PARAM_OF_MAX = 2**-7
# The loss, dense: the mean of 4 x 2047 NLLs of logits about an ulp apart
# (the forward's limit, 1e-3). MoE: a routing flip between the two runs
# moves its position's NLL by about a nat, the mean over 8188 positions by
# about 1.2e-4; 0.01 allows 80 flips, 1% of a layer's tokens (0.1-0.3%
# flipped between two attentions an ulp apart on an H100; MOE_ROUTE_GAP).
ONE_PROCESS_LOSS_ATOL = {"dense": 1e-3, "MoE": 0.01}
# The grow check's optimizer: the reference's optax.adamw(1e-3,
# weight_decay=1e-4); and the seed of its weights and token batches.
GROW_ADAMW = dict(lr=1e-3, weight_decay=1e-4)
GROW_SEED = 400
# Host-clock parts of a hot-add that are cheap to repeat, each timed so
# often (the median is reported).
GROW_REPEATS = 3
# The dryrun's token batch: (8, 16), as the reference's.
DRYRUN_TOKENS = (8, 16)
# The dryrun's stretch: the reference's v5litepod-16 run over 16 devices,
# laid out by the H100 plan (2 hosts of 8).
STRETCH = dict(ACCEL="nvidia-h100-80gb", GPUS=16, SEED=2)


def entry(device="cuda"):
    """(fn, example_args): the forward step of the default probe config,
    seeded weights, zero tokens (4, 32). Runs on the card unless the caller
    passes device="cpu". On the card fn is what the reference's harness
    jits: its first call captures the forward as a CUDA graph, and later
    calls with tokens of that shape replay it (``ops.graphs``)."""
    device = resolve_device(device)
    cfg = TransformerConfig()
    params = init_params(cfg, torch.Generator().manual_seed(0), device)
    tokens = torch.zeros((4, 32), dtype=torch.long, device=device)

    def fn(params, tokens):
        return forward(params, tokens, cfg)

    return fn, (params, tokens)


def check_config(**changes) -> TransformerConfig:
    """The checks' dialect: the reference's dryrun flagship
    (``__graft_entry__._flagship_cfg``: 16 q heads, 8 kv heads, window 8,
    RoPE, 2 layers, d_ff 128, max_len 32, bf16) at d_model 512, so d_head
    32 (``train_check`` says why), with `changes`."""
    cfg = TransformerConfig(n_layers=2, d_model=512, n_heads=16, d_ff=128,
                            max_len=32, n_kv_heads=8, window=8, rope=True)
    return dataclasses.replace(cfg, **changes)


def check_tokens(cfg, split: int = 1) -> torch.Tensor:
    """The checks' batch: tokens (8, 16) from numpy seed 0, on the CPU; its
    first split·⌊8/split⌋ rows, so that they split `split` ways (all of
    them where split divides 8)."""
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, DRYRUN_TOKENS)
    return torch.from_numpy(tokens[:split * (DRYRUN_TOKENS[0] // split)])


def train_check(device="cuda") -> dict:
    """One SGD step of the reference's flagship dialect on tokens (8, 16)
    from numpy seed 0, then its grads through the kernels held leaf by leaf
    against the grads with ``attention=attention_plain`` (autograd through
    the plain forward), within the reference's 5e-3: the single-GPU form of
    ``__graft_entry__.py:150-167``. Runs on the card unless the caller
    passes device="cpu".

    The config is ``__graft_entry__._flagship_cfg`` (16 q heads, 8 kv
    heads, window 8, RoPE, 2 layers, d_ff 128, max_len 32, bf16) at
    d_model 512 in place of 64. The flagship's d_head is 64 / 16 = 4, and
    no kernel of the port takes it: flash_fwd.cu and flash_bwd.cu take
    head dims 32, 64 and 128, and a CUDA tensor with another head dim
    raises ValueError. The kernels do not pad small head dims; this check
    uses d_head 32 and keeps every other field.

    Returns {"loss": ..., "max_grad_err": ...}; raises RuntimeError when
    the loss is not finite or a grad is off.
    """
    device = resolve_device(device)
    cfg = check_config()
    params = init_params(cfg, torch.Generator().manual_seed(0), device)
    tokens = check_tokens(cfg).to(device)
    _, loss = make_train_step(cfg)(params, tokens)
    if not torch.isfinite(loss):
        raise RuntimeError(f"train step loss is not finite: {loss.item()}")
    _, grads = loss_and_grads(params, tokens, cfg)
    _, plain = loss_and_grads(params, tokens, cfg, attention=attention_plain)
    err = max((g.float() - p.float()).abs().max().item()
              for g, p in zip(tree_leaves(grads), tree_leaves(plain)))
    if not err < TRAIN_GRAD_ATOL:
        raise RuntimeError(f"grads through the kernels vs the plain "
                           f"attention: max abs err {err} >= "
                           f"{TRAIN_GRAD_ATOL}")
    return {"loss": loss.item(), "max_grad_err": err}


def route_flips(xa: torch.Tensor, xa_ref: torch.Tensor, p: dict) -> dict:
    """Routing of an MoE block's FFN input in two runs: xa and xa_ref (b, t,
    d_model) are the residual streams after attention. Returns the mask of
    tokens (b, t) routed to another expert than in the ref run, the largest
    ref-run top-1/top-2 router-logit gap among them (0.0 without one), and
    the max |difference| of the router logits. Raises when a token whose
    gap exceeds MOE_ROUTE_GAP flipped."""
    h, h_ref = (_rmsnorm(a, p["ln2"]).flatten(0, 1) for a in (xa, xa_ref))
    flipped = _route(p, h)[0] != _route(p, h_ref)[0]
    logits, logits_ref = (a.float() @ p["router"] for a in (h, h_ref))
    top2 = logits_ref.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    worst = gap[flipped].max().item() if flipped.any() else 0.0
    logit_err = (logits - logits_ref).abs().max().item()
    if worst > MOE_ROUTE_GAP:
        raise RuntimeError(f"a token whose top-1/top-2 router-logit gap is {worst} > "
                           f"{MOE_ROUTE_GAP} went to another expert")
    return {"flipped": flipped.view(xa.shape[:2]), "worst_gap": worst, "logit_err": logit_err}


def _masked_err(got, want, keep):
    """max |got − want| over the tokens kept (keep: (b, t) bool)."""
    return ((got.float() - want.float()).abs() * keep[..., None]).max().item()


def moe_blocks_vs_plain(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
                        grads: bool = False) -> list[dict]:
    """An MoE model's blocks with flash_attention against the same blocks
    with attention_plain, layer by layer: each layer's input comes from the
    kernel run, and both blocks run on it, so a routing flip changes only
    its own token. Per layer: the flipped tokens (``route_flips``, which
    raises on a flip beyond MOE_ROUTE_GAP), the block output's max abs err
    over the unflipped tokens and the plain output's max |value|.

    grads=True also gives, per layer, the grads of every block leaf and of
    the block's input ("x"): both blocks are differentiated against the
    kernel model's own cotangent of loss_fn at that block's output, with
    the flipped tokens' rows zeroed, plus the block's share of the aux
    term, so the kernel side's leaf grads are loss_fn's grads less the
    flipped tokens'. Each entry is (max abs err, plain grad's max |value|).
    """
    if cfg.n_experts is None:
        raise ValueError("moe_blocks_vs_plain needs an MoE config")
    cotangents = []
    if grads:  # loss_fn through the kernels, keeping each block's output
        x, outs, aux_total = _embed(params, tokens, cfg).detach().requires_grad_(), [], 0.0
        for blk in params["blocks"]:
            x, aux = _block(x, blk, cfg, flash_attention)
            outs.append(x)
            aux_total = aux_total + aux
        loss = (next_token_nll((x @ params["embed"].T).float(), tokens)
                + cfg.moe_aux_weight * aux_total / cfg.n_layers)
        cotangents = torch.autograd.grad(loss, outs)
    records = []
    x = _embed(params, tokens, cfg).detach()
    with torch.set_grad_enabled(grads):
        for i, blk in enumerate(params["blocks"]):
            runs = []  # (block leaves, block input, x after attention, output, aux)
            for attention in (flash_attention, attention_plain):
                leaves = {key: value.detach().requires_grad_(grads) for key, value in blk.items()}
                x_in = x.detach().requires_grad_(grads)
                xa = _attend(x_in, leaves, cfg, attention)[0]
                runs.append((leaves, x_in, xa, *_finish_block(xa, leaves)))
            (_, _, xa_k, out_k, _), (_, _, xa_p, out_p, _) = runs
            record = route_flips(xa_k, xa_p, blk)
            keep = ~record["flipped"]
            record.update(out_err=_masked_err(out_k, out_p, keep),
                          out_max=out_p.float().abs().max().item())
            if grads:
                cot = cotangents[i] * keep[..., None]
                got, want = (torch.autograd.grad(
                    (out.float() * cot.float()).sum() + cfg.moe_aux_weight * aux / cfg.n_layers,
                    [leaves[key] for key in sorted(blk)] + [x_in])
                    for leaves, x_in, _, out, aux in runs)
                record["grads"] = {name: ((g.float() - w.float()).abs().max().item(),
                                          w.float().abs().max().item())
                                   for name, g, w in zip(sorted(blk) + ["x"], got, want)}
            records.append(record)
            x = out_k.detach()
    return records


def moe_check(device="cuda") -> dict:
    """The single-GPU form of the dryrun's two MoE parts
    (``__graft_entry__.py:195-201, 268-284``). Runs on the card unless the
    caller passes device="cpu".

    1. One SGD step of the MoE flagship: train_check's config (the
       reference's flagship at d_head 32) with n_experts 8 and d_ff 64, as
       the dryrun replaces them, on tokens (8, 16) from numpy seed 0. Its
       grads through the kernels are held against those through the plain
       attention within the reference's 5e-3, block by block
       (``moe_blocks_vs_plain``): a routing flip is a discontinuity, not a
       fault, and the block check leaves the flipped tokens out.
    2. Three steps of the standalone MoE layer, ``make_moe_step`` with 2
       experts, d_model 32, d_ff 64, on bf16 ones (8, 32) as input and
       target.

    Returns {"loss", "max_grad_err", "flipped" (per layer),
    "moe_step_losses"}; raises RuntimeError when a loss is not finite or a
    grad is off.
    """
    device = resolve_device(device)
    cfg = check_config(n_experts=8, d_ff=64)
    params = init_params(cfg, torch.Generator().manual_seed(0), device)
    tokens = check_tokens(cfg).to(device)
    new, loss = make_train_step(cfg)(params, tokens)
    if not (torch.isfinite(loss) and all(torch.isfinite(t).all() for t in tree_leaves(new))):
        raise RuntimeError(f"MoE train step: loss {loss.item()}, or params not finite")
    records = moe_blocks_vs_plain(params, tokens, cfg, grads=True)
    err = max(e for record in records for e, _ in record["grads"].values())
    if not err < TRAIN_GRAD_ATOL:
        raise RuntimeError(f"MoE grads through the kernels vs the plain attention: max "
                           f"abs err {err} >= {TRAIN_GRAD_ATOL}")

    step = make_moe_step(2, 32, 64)
    moe_params = init_moe_params(torch.Generator().manual_seed(1), 2, 32, 64,
                                 torch.bfloat16, device)
    xs = torch.ones((8, 32), dtype=torch.bfloat16, device=device)
    moe_losses = []
    for _ in range(3):
        moe_params, moe_loss = step(moe_params, xs, xs)
        moe_losses.append(moe_loss.item())
    if not all(map(math.isfinite, moe_losses)):
        raise RuntimeError(f"MoE layer step losses not finite: {moe_losses}")
    return {"loss": loss.item(), "max_grad_err": err,
            "flipped": [int(r["flipped"].sum()) for r in records],
            "moe_step_losses": moe_losses}


# --- sharded: the dryrun's dp x tp and expert-parallel sections ---


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def kernel_launches() -> dict:
    """The training kernels' launch counts in this process."""
    return launch_counts(TRAINING)


def reset_kernel_launches() -> None:
    reset_launch_counts(TRAINING)


def local_shapes(cfg: TransformerConfig, mesh) -> list[tuple]:
    """The shapes of one rank's shards, in ``tree_leaves`` order: each
    leaf's whole shape with the dim that ``param_specs`` splits over
    "model" divided by its size, and wqkv's columns those of the rank's
    q, k and v heads."""
    tp = mesh.size("model")
    n_q, n_kv = local_heads(cfg, mesh)
    full = {"embed": (cfg.vocab, cfg.d_model), "pos": (cfg.max_len, cfg.d_model),
            "wqkv": (cfg.d_model, (n_q + 2 * n_kv) * cfg.d_head * tp),
            "wo": (cfg.d_model, cfg.d_model), "ln1": (cfg.d_model,), "ln2": (cfg.d_model,),
            "w1": (cfg.d_model, cfg.d_ff), "w2": (cfg.d_ff, cfg.d_model)}
    if cfg.n_experts is not None:
        e = cfg.n_experts
        full.update(router=(cfg.d_model, e), w1=(e, cfg.d_model, cfg.d_ff),
                    w2=(e, cfg.d_ff, cfg.d_model))

    def local(key, spec):
        return tuple(n // tp if axis == "model" else n for n, axis in zip(full[key], spec))

    specs = param_specs(cfg)
    return ([local(k, specs[k]) for k in sorted(specs) if k != "blocks"]
            + [local(k, blk[k]) for blk in specs["blocks"] for k in sorted(blk)])


def _check_equal_over(local: dict, mesh, axis: str, keys=None) -> None:
    """Raises unless each leaf named in `keys` (every leaf by default) is
    bit-equal on every rank along `axis`."""
    for name, leaf in zip(tree_names(local), tree_leaves(local), strict=True):
        if keys is None or name.rsplit(".", 1)[-1] in keys:
            for r, other in enumerate(all_gather(leaf, mesh, axis)):
                if not torch.equal(other, leaf):
                    raise RuntimeError(f"{name} differs between rank {mesh.rank} and its "
                                       f"{axis!r} neighbour {r} after the step")


def sharded_step_check(cfg: TransformerConfig, mesh, params: dict, tokens: torch.Tensor,
                       lr: float = 1e-3) -> dict:
    """One ``make_train_step`` step of full params (on the CPU: only the
    shards reach the device) sharded over `mesh`, with the checks that
    stand in for the dryrun's "no involuntary rematerialization": this
    rank's leaves, before and after, have their local shapes; the step's
    collectives are ``step_collectives``' all-reduces, of its own shards
    and activations, and nothing gathers a weight; and after the step every
    leaf is bit-equal along "data", and every replicated one along
    "model". On a CUDA mesh each training kernel launches n_layers times,
    on this rank's heads. Returns {"local": new shards, "loss", "launches",
    "collectives"}; raises RuntimeError when a check fails."""
    local = shard_params(params, mesh, cfg)
    want = local_shapes(cfg, mesh)
    got = [tuple(t.shape) for t in tree_leaves(local)]
    if got != want:
        raise RuntimeError(f"rank {mesh.rank}: shards of shapes {got}, expected {want}")
    step = make_train_step(cfg, lr=lr, mesh=mesh)
    mesh.reset_counts()
    reset_kernel_launches()
    new, loss = step(local, tokens)
    _sync(mesh.device)
    counts = {"calls": dict(mesh.calls), "bytes": dict(mesh.bytes)}
    launches = kernel_launches()
    if not math.isfinite(loss.item()):
        raise RuntimeError(f"rank {mesh.rank}: sharded step loss {loss.item()}")
    expected = step_collectives(cfg, mesh, local, tuple(tokens.shape))
    if counts != expected:
        raise RuntimeError(f"rank {mesh.rank}: collectives of a step {counts}, "
                           f"expected {expected}")
    n = cfg.n_layers if mesh.device.type == "cuda" else 0
    if launches != dict.fromkeys(("flash_fwd", "dq", "dkv"), n):
        raise RuntimeError(f"rank {mesh.rank}: kernel launches {launches}, {n} each expected")
    if [tuple(t.shape) for t in tree_leaves(new)] != want:
        raise RuntimeError(f"rank {mesh.rank}: the new shards changed shape")
    _check_equal_over(new, mesh, "data")
    _check_equal_over(new, mesh, "model", {"embed", "pos", "ln1", "ln2", "router"})
    return {"local": new, "loss": loss.item(), "launches": launches, "collectives": counts}


def tp_checks(mesh) -> dict:
    """The dryrun's sharded sections (``__graft_entry__.py:141-167, 191-201,
    268-284``) on this rank of a ("data", "model") mesh, at ``check_config``'s
    dialect; every rank of the mesh calls it together.

    1. One dp x tp SGD step (``sharded_step_check``), finite loss.
    2. Its gradients through the kernels held against those through
       ``attention_plain`` on the same mesh, leaf by leaf on this rank's
       shards, within the reference's 5e-3; each attention call on
       H/tp q heads and H_kv/tp kv heads.
    3. The MoE flagship (8 experts, d_ff 64) over the same mesh, its
       experts split over "model": one step, the same checks.
    4. ``make_moe_step`` over a ("data", "expert") mesh of the same ranks
       (2 experts a rank of "expert", 2 ranks on it where the world is
       even), 3 steps of d_model 32, d_ff 64 on bf16 ones (8, 32).

    Each batch is its first rows that split over "data" (all 8 unless the
    data axis does not divide 8).

    Returns {"loss", "max_grad_err", "heads", "launches", "collectives",
    "moe_loss", "moe_launches", "moe_collectives", "moe_step_losses"}."""
    cfg = check_config()
    tokens = check_tokens(cfg, mesh.size("data"))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    dense = sharded_step_check(cfg, mesh, params, tokens)

    local = shard_params(params, mesh, cfg)
    heads = []

    def recording(q, k, v, **kw):
        heads.append((q.shape[1], k.shape[1]))
        return flash_attention(q, k, v, **kw)

    _, grads = loss_and_grads(local, tokens, cfg, attention=recording, mesh=mesh)
    _, plain = loss_and_grads(local, tokens, cfg, attention=attention_plain, mesh=mesh)
    if heads != [local_heads(cfg, mesh)] * cfg.n_layers:
        raise RuntimeError(f"rank {mesh.rank}: attention ran on (q, kv) heads {heads}")
    err = max((g.float() - p.float()).abs().max().item()
              for g, p in zip(tree_leaves(grads), tree_leaves(plain)))
    if not err < TRAIN_GRAD_ATOL:
        raise RuntimeError(f"rank {mesh.rank}: grads through the kernels vs the plain "
                           f"attention on the mesh: max abs err {err} >= {TRAIN_GRAD_ATOL}")

    moe_cfg = check_config(n_experts=8, d_ff=64)
    moe = sharded_step_check(moe_cfg, mesh, init_params(
        moe_cfg, torch.Generator().manual_seed(0), "cpu"), tokens)

    world = mesh.size("data") * mesh.size("model")
    ep = 2 if world % 2 == 0 else 1
    expert_mesh = build_mesh((world // ep, ep), ("data", "expert"), mesh.device)
    step = make_moe_step(2 * ep, 32, 64, mesh=expert_mesh)
    moe_params = shard_moe_params(init_moe_params(
        torch.Generator().manual_seed(1), 2 * ep, 32, 64, torch.bfloat16, "cpu"), expert_mesh)
    n_data = world // ep
    xs = torch.ones((n_data * (DRYRUN_TOKENS[0] // n_data), 32), dtype=torch.bfloat16)
    moe_losses = []
    for _ in range(3):
        moe_params, moe_loss = step(moe_params, xs, xs)
        moe_losses.append(moe_loss.item())
    if not all(map(math.isfinite, moe_losses)):
        raise RuntimeError(f"rank {mesh.rank}: MoE layer step losses {moe_losses}")
    return {"loss": dense["loss"], "max_grad_err": err, "heads": heads,
            "launches": dense["launches"], "collectives": dense["collectives"],
            "moe_loss": moe["loss"], "moe_launches": moe["launches"],
            "moe_collectives": moe["collectives"],
            "moe_step_losses": moe_losses}


def _tp_check_rank(shape, device) -> dict:
    result = tp_checks(build_mesh(shape, device=device))
    result["rank"] = torch.distributed.get_rank()
    return result


def tp_train_check(n_data: int, n_model: int, device="cuda", *, backend: str,
                   timeout_s: float = 600.0) -> dict:
    """``tp_checks`` on an (n_data, n_model) mesh of n_data x n_model
    ranks, started as processes (``parallel.launch.run_ranks``) that join a
    process group of `backend`: the counterpart of the dryrun's dp x tp
    and expert-parallel sections on a mesh. The caller names the backend;
    nothing here swaps one for another (NCCL refuses two ranks on one
    device, gloo takes CUDA tensors by way of the host). Runs on the card
    unless the caller passes device="cpu"; each rank's device is
    ``build_mesh``'s. Returns rank 0's results, with "max_grad_err" the
    largest over the ranks and "ranks" every rank's; raises when a rank
    fails, naming it."""
    if torch.device(device).type == "cuda":
        resolve_device(device)
    results = run_ranks(_tp_check_rank, n_data * n_model, backend=backend,
                        args=((n_data, n_model), device), timeout_s=timeout_s)
    losses = {r["loss"] for r in results}
    if len(losses) != 1:
        raise RuntimeError(f"the ranks' losses differ: {sorted(losses)}")
    return {**results[0], "max_grad_err": max(r["max_grad_err"] for r in results),
            "ranks": results}


# --- sharded: the dryrun's dp x sp, ring and pipeline sections ---


def _dryrun_config(device: torch.device, **changes) -> TransformerConfig:
    """The dryrun's flagship (d_head 4) on the CPU; ``check_config``'s
    dialect (d_head 32) on the card, whose kernels take head dims 32, 64
    and 128."""
    if device.type == "cuda":
        return check_config(**changes)
    return check_config(d_model=64, **changes)


def _ring_case(mesh, shape: tuple, seed: int, grads: bool) -> dict:
    """ring_attention over the ("seq",) mesh on this rank's chunks of
    numpy-seeded q, k, v (normal x 0.3, f32) against reference_attention
    over the whole sequence, within RING_TOL; with grads, also the gradient
    of sum(out²) in q, which must be finite. Returns the max abs error."""
    rng = np.random.default_rng(seed)
    full = [torch.from_numpy(rng.normal(size=shape) * 0.3).float() for _ in range(3)]
    q, k, v = (shard_qkv(t, mesh).requires_grad_(grads) for t in full)
    out = ring_attention(q, k, v, mesh)
    want = shard_qkv(reference_attention(*full), mesh)
    if not torch.allclose(out.detach(), want, **RING_TOL):
        raise RuntimeError(f"rank {mesh.rank}: ring attention at {shape} differs from "
                           f"reference_attention")
    result = {"max_abs_err": (out.detach() - want).abs().max().item()}
    if grads:
        (dq,) = torch.autograd.grad(out.square().sum(), [q])
        if not torch.isfinite(dq).all():
            raise RuntimeError(f"rank {mesh.rank}: ring attention's grad is not finite")
    return result


def seq_checks(mesh) -> dict:
    """The dryrun's sequence-parallel sections (``__graft_entry__.py:203-266``)
    on this rank of a (data, seq) mesh; every rank of the world calls it
    together. CUDA ranks use ``check_config``'s dialect (d_head 32), CPU
    ranks the dryrun's own (d_head 4).

    1. One dp x sp SGD step of the dialect with window None and
       attn_parallel "seq" (seed 4), its loss against the unsharded loss
       of the same weights and tokens within 1e-2; on a CUDA rank at seq
       coordinate c each training kernel launches (c + 1)·n_layers times.
       The batch is the check batch's first rows that split over data, all
       8 unless the data axis does not divide 8 (``seq_mesh_shape``).
    2. Ring attention over a ("seq",) mesh of every rank: q, k, v (2, 2,
       8n, D) against reference_attention within 5e-2, D = 8 (32 on the
       card).
    3. Ring-flash: (2, 2, 16n, D), D = 16 (32 on the card), the same
       check, and the grad of sum(out²) in q finite. The port has one ring
       body, the flash one, so 2 and 3 differ in shapes only.

    Returns {"loss", "loss_unsharded", "loss_err", "launches", "ring_err",
    "ring_flash_err"}."""
    device = mesh.device
    cfg = _dryrun_config(device, window=None, attn_parallel="seq")
    tokens = check_tokens(cfg, mesh.size(mesh.axis_names[0]))
    params = init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    local = shard_params(params, mesh, cfg)
    reset_kernel_launches()
    _, loss = make_train_step(cfg, mesh=mesh)(local, tokens)
    _sync(device)
    launches = kernel_launches()
    if not math.isfinite(loss.item()):
        raise RuntimeError(f"rank {mesh.rank}: non-finite seq-parallel loss {loss.item()}")
    with torch.no_grad():
        ref = loss_fn(local, tokens.to(device), dataclasses.replace(cfg, attn_parallel="heads"))
    err = abs(loss.item() - ref.item())
    if not err < SHARDED_LOSS_ATOL:
        raise RuntimeError(f"rank {mesh.rank}: seq-parallel first-step loss {loss.item()} vs "
                           f"unsharded {ref.item()} (|d|={err})")
    world = mesh.size(mesh.axis_names[0]) * mesh.size(mesh.axis_names[1])
    seq_mesh = build_mesh((world,), ("seq",), device)
    d_ring, d_flash = (32, 32) if device.type == "cuda" else (8, 16)
    ring = _ring_case(seq_mesh, (2, 2, 8 * world, d_ring), 0, grads=False)
    ring_flash = _ring_case(seq_mesh, (2, 2, 16 * world, d_flash), 1, grads=True)
    return {"loss": loss.item(), "loss_unsharded": ref.item(), "loss_err": err,
            "launches": launches, "ring_err": ring["max_abs_err"],
            "ring_flash_err": ring_flash["max_abs_err"]}


def pipeline_checks(mesh) -> dict:
    """The dryrun's pipeline sections (``__graft_entry__.py:286-336``) on
    this rank of a ("pipe",) mesh of P ranks; every rank calls it together.

    1. GPipe over P stages of tanh(x @ w), w = 0.9·I (16), on ones (8, 16)
       in 4 microbatches: finite, and equal to the stages run in turn
       within 1e-6.
    With P >= 2 (the reference's sections fail below that; one stage has
    no bubble):

    2. The bubble accounting: the interleaved schedule (v 2) has a smaller
       bubble fraction than GPipe's at the same microbatches and stages.
    3. The interleaved flagship: 2 chunks a rank, 2P blocks of the dialect
       (seed 5), n_micro the least multiple of P that is >= 4 (the
       reference's 4 fails for 3 stages), on the first n_micro·⌊8/n_micro⌋
       rows of the check batch: one step, its loss against the unsharded
       loss within 1e-2. On a CUDA rank each training kernel launches
       n_micro·2 times (one block a chunk).

    Returns {"gpipe_err", "bubble": {"gpipe", "interleaved"}, and with P >=
    2 "loss", "loss_unsharded", "loss_err", "n_micro", "launches"}."""
    device = mesh.device
    n_stages = mesh.size(mesh.axis_names[0])
    w = torch.eye(16) * 0.9
    stages = shard_stage_params({"w": torch.stack([w] * n_stages)}, mesh, mesh.axis_names[0])
    x = torch.ones((8, 16), device=device)
    y = pipeline_apply(stages, x, mesh, lambda p, a: torch.tanh(a @ p["w"]), n_micro=4,
                       pipe_axis=mesh.axis_names[0])
    want = x
    for _ in range(n_stages):
        want = torch.tanh(want @ w.to(device))
    gpipe_err = (y - want).abs().max().item()
    if not (torch.isfinite(y).all() and gpipe_err <= 1e-6):
        raise RuntimeError(f"rank {mesh.rank}: GPipe output off by {gpipe_err}")
    n_virtual, n_micro = 2, n_stages * math.ceil(4 / n_stages)
    bubble = {"gpipe": schedule_info(n_micro, n_stages)["bubble_fraction"],
              "interleaved": schedule_info(n_micro, n_stages, n_virtual)["bubble_fraction"]}
    out = {"gpipe_err": gpipe_err, "bubble": bubble}
    if n_stages < 2:  # one stage has no bubble to shrink
        return out
    if not bubble["interleaved"] < bubble["gpipe"]:
        raise RuntimeError(f"interleaving does not shrink the bubble: {bubble}")
    cfg = _dryrun_config(device, n_layers=n_stages * n_virtual)
    tokens = check_tokens(cfg, n_micro)
    params = init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    local = shard_pipeline_params(to_pipeline_params(params, n_stages, n_virtual), mesh,
                                  mesh.axis_names[0])
    step = make_pipeline_train_step(mesh, cfg, n_micro=n_micro, pipe_axis=mesh.axis_names[0],
                                    n_virtual=n_virtual)
    reset_kernel_launches()
    _, loss = step(local, tokens)
    _sync(device)
    launches = kernel_launches()
    if not math.isfinite(loss.item()):
        raise RuntimeError(f"rank {mesh.rank}: non-finite pipeline loss {loss.item()}")
    with torch.no_grad():
        ref = loss_fn(tree_map(lambda t: t.to(device), params), tokens.to(device), cfg)
    err = abs(loss.item() - ref.item())
    if not err < SHARDED_LOSS_ATOL:
        raise RuntimeError(f"rank {mesh.rank}: pipeline first-step loss {loss.item()} vs "
                           f"unsharded {ref.item()} (|d|={err})")
    return {**out, "loss": loss.item(), "loss_unsharded": ref.item(), "loss_err": err,
            "n_micro": n_micro, "launches": launches}


def _seq_pipeline_rank(shape, device) -> dict:
    seq = seq_checks(build_mesh(shape, ("data", "seq"), device))
    pipe = pipeline_checks(build_mesh((shape[0] * shape[1],), ("pipe",), device))
    return {"rank": torch.distributed.get_rank(), "seq": seq, "pipeline": pipe}


def seq_pipeline_check(n_data: int, n_seq: int, device="cuda", *, backend: str,
                       timeout_s: float = 600.0) -> list[dict]:
    """``seq_checks`` on an (n_data, n_seq) ("data", "seq") mesh, then
    ``pipeline_checks`` on a ("pipe",) mesh of the same n_data·n_seq ranks,
    started as processes (``parallel.launch.run_ranks``) that join a process
    group of `backend`: the counterpart of the dryrun's dp x sp, ring and
    pipeline sections. The caller names the backend; nothing here swaps one
    for another. Runs on the card unless the caller passes device="cpu".
    Returns every rank's results; raises when a rank fails, naming it, or
    when the ranks' losses differ."""
    if torch.device(device).type == "cuda":
        resolve_device(device)
    results = run_ranks(_seq_pipeline_rank, n_data * n_seq, backend=backend,
                        args=((n_data, n_seq), device), timeout_s=timeout_s)
    for part in ("seq", "pipeline"):
        losses = {r[part].get("loss") for r in results}
        if len(losses) != 1:
            raise RuntimeError(f"the ranks' {part} losses differ: {sorted(losses)}")
    return results


# --- the hot-add that grows a job's mesh ---


def _timed(fn, device: torch.device) -> tuple:
    """(fn(), host ms from the call to its end on `device`)."""
    _sync(device)
    t0 = time.perf_counter()
    value = fn()
    _sync(device)
    return value, (time.perf_counter() - t0) * 1e3


def _adamw(cfg: TransformerConfig, mesh=None):
    return make_train_step_optim(cfg, lambda ps: torch.optim.AdamW(ps, **GROW_ADAMW), mesh)


def _grow_specs(cfg: TransformerConfig) -> tuple:
    """The spec trees of a packed (params, optimizer state) pair."""
    specs = param_specs(cfg)
    return specs, optimizer_state_specs(specs)


def _moments(opt_tree: dict, params: dict, key: str) -> dict:
    """The optimizer state's `key` ("exp_avg" or "exp_avg_sq") of every
    parameter, as a tree of the params' layout."""
    state = iter([opt_tree["state"][str(i)][key] for i in range(len(tree_leaves(params)))])
    return tree_map(lambda _: next(state), params)


def _bit_equal(what: str, got: dict, want: dict, rank: int) -> None:
    for name, g, w in zip(tree_names(want), tree_leaves(got), tree_leaves(want), strict=True):
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g.to(w.device), w):
            raise RuntimeError(f"rank {rank}: {what} {name} is not bit-equal to what it should "
                               f"be ({g.dtype} {tuple(g.shape)} against {w.dtype} "
                               f"{tuple(w.shape)})")


def against_one_process(what: str, new_full: dict, loss: float, want: dict, want_loss: float,
                        loss_atol: float) -> dict:
    """A sharded step's gathered new params and loss against the
    one-process step's (want, want_loss) from the same state: each leaf
    within SHARDED_PARAM_OF_MAX of its max |value|, the loss within
    loss_atol. Returns {"loss_one_process", "loss_err", "worst_param":
    (share of max, leaf)}; raises RuntimeError beyond a limit."""
    worst, bad = (0.0, ""), []
    for leaf, g, w in zip(tree_names(want), tree_leaves(new_full), tree_leaves(want),
                          strict=True):
        share = (g.float() - w.float()).abs().max().item() / w.float().abs().max().item()
        worst = max(worst, (share, leaf))
        if not share <= SHARDED_PARAM_OF_MAX:
            bad.append(leaf)
    loss_err = abs(loss - want_loss)
    if bad or not loss_err <= loss_atol:
        raise RuntimeError(f"{what} vs the one-process step: params {bad} beyond "
                           f"{SHARDED_PARAM_OF_MAX} of their max |value| (worst {worst}), loss "
                           f"{loss} vs {want_loss} (limit {loss_atol})")
    return {"loss_one_process": want_loss, "loss_err": loss_err, "worst_param": worst}


def _kind(cfg: TransformerConfig) -> str:
    return "dense" if cfg.n_experts is None else "MoE"


def grow_pack(mesh, cfg: TransformerConfig, params: dict, batches: list, path: str) -> dict:
    """The first world of a mesh-growing hot-add, on this rank of a
    ("data", "model") mesh; every rank calls it together. Shards the whole
    `params` (on the CPU), takes one AdamW step (GROW_ADAMW) a batch
    (numpy tokens), packs the params and the optimizer's state through
    their specs (``HotResumable.pack`` over the mesh: every leaf gathered
    whole on every rank), and rank 0 saves to `path` while the others wait
    at a barrier. The pack and the save are each timed GROW_REPEATS times
    (host ms). Returns {"losses", "launches" (this rank's training kernels
    in the steps), "names" (``tree_leaves`` order), "times": {"pack",
    "save"}, "state" (the packed HotResumable)}."""
    local = shard_params(params, mesh, cfg)
    init_fn, step_fn = _adamw(cfg, mesh)
    opt = init_fn(local)
    reset_kernel_launches()
    losses = []
    for tokens in batches:
        local, opt, loss = step_fn(local, opt, torch.from_numpy(tokens))
        losses.append(loss.item())
    launches = kernel_launches()
    specs = _grow_specs(cfg)
    times = {"pack": [], "save": []}
    for _ in range(GROW_REPEATS):
        state, ms = _timed(lambda: HotResumable.pack(local, optimizer_state_tree(opt),
                                                     specs=specs, mesh=mesh), mesh.device)
        times["pack"].append(ms)
    if mesh.rank == 0:  # one writer: save's flock would serialise every rank's
        for _ in range(GROW_REPEATS):
            times["save"].append(_timed(lambda: state.save(path), mesh.device)[1])
    dist.barrier()
    return {"losses": losses, "launches": launches, "names": tree_names(local),
            "times": times, "state": state}


def _one_process_step(state: HotResumable, cfg: TransformerConfig, tokens: np.ndarray,
                      grads: dict, device: torch.device) -> tuple:
    """In this process, from the packed state whole on `device`: the loss of
    the params on `tokens`, and one AdamW update of the params with the
    given whole `grads` (the state's optimizer, loaded as
    ``load_optimizer_state`` does). Returns (new params, loss)."""
    params, opt_tree = state.restore(device)
    with torch.no_grad():
        loss = loss_fn(params, torch.from_numpy(tokens).to(device), cfg).item()
    init_fn, _ = _adamw(cfg)
    opt = init_fn(params)
    load_optimizer_state(opt, opt_tree)
    for leaf, grad in zip(tree_leaves(params), tree_leaves(grads), strict=True):
        leaf.grad = grad
    opt.step()
    return params, loss


def grow_restore(mesh, cfg: TransformerConfig, batches: list, path: str) -> dict:
    """The second world of a mesh-growing hot-add, on this rank of the new
    ("data", "model") mesh; every rank calls it together. Loads the
    checkpoint at `path` and restores this rank's shards of the params and
    the optimizer's state (``HotResumable.restore`` with specs on the
    mesh), and raises unless they are bit-equal to ``shard_params`` of the
    packed whole params and moments, and the params gathered again
    bit-equal to the packed ones. Then builds AdamW over the shards, loads
    the state (each moment bit-equal to its restored shard) and takes one
    step a batch. The first step is held against one process from the
    same state on rank 0's device (``against_one_process``): its loss
    against the whole params' loss (ONE_PROCESS_LOSS_ATOL), and its
    gathered new params against the whole optimizer's update with the
    step's gathered gradients (SHARDED_PARAM_OF_MAX): the restored state
    must give the update one process gives. The gradients themselves are
    the sharded step's, which ``tp_checks`` and ``sharded_step_check`` hold
    (a whole AdamW step of its own would differ wherever a top-1 route
    flips between the two runs, since AdamW scales each element's update to
    about lr whatever its gradient). Load, restore and the
    optimizer's state are each timed GROW_REPEATS times, the first step
    once (host ms). Returns {"losses", "launches" (this rank's training
    kernels in its steps), "names", "times": {"load", "restore",
    "optimizer", "first_step"}, "one_process" (rank 0's comparison, else
    {}), "local" (the new shards)}."""
    device, rank = mesh.device, mesh.rank
    times = {"load": [], "restore": [], "optimizer": []}
    for _ in range(GROW_REPEATS):
        state, ms = _timed(lambda: HotResumable.load(path), device)
        times["load"].append(ms)
    specs = _grow_specs(cfg)
    for _ in range(GROW_REPEATS):
        (local, opt_tree), ms = _timed(lambda: state.restore(specs=specs, mesh=mesh), device)
        times["restore"].append(ms)
    whole, whole_opt = state.host_state
    _bit_equal("restored params", local, shard_params(whole, mesh, cfg), rank)
    for key in ("exp_avg", "exp_avg_sq"):
        _bit_equal(f"restored {key}", _moments(opt_tree, local, key),
                   shard_params(_moments(whole_opt, whole, key), mesh, cfg), rank)
    _bit_equal("gathered restored params", gather_params(local, mesh, cfg), whole, rank)

    init_fn, step_fn = _adamw(cfg, mesh)

    def optimizer():
        opt = init_fn(local)
        load_optimizer_state(opt, opt_tree)
        return opt

    for _ in range(GROW_REPEATS):
        opt, ms = _timed(optimizer, device)
        times["optimizer"].append(ms)
    for key in ("exp_avg", "exp_avg_sq"):
        loaded = tree_map(lambda leaf: opt.state[leaf][key], local)
        _bit_equal(f"loaded {key}", loaded, _moments(opt_tree, local, key), rank)

    reset_kernel_launches()
    (local, opt, loss), times["first_step"] = _timed(
        lambda: step_fn(local, opt, torch.from_numpy(batches[0])), device)
    launches = kernel_launches()
    losses = [loss.item()]
    new_whole = gather_params(local, mesh, cfg)
    grads = gather_params(tree_map(lambda leaf: leaf.grad, local), mesh, cfg)
    one_process = {}
    if rank == 0:
        want, want_loss = _one_process_step(state, cfg, batches[0], grads, device)
        one_process = against_one_process(f"rank 0: the grown {_kind(cfg)} world's first step",
                                          new_whole, losses[0], want, want_loss,
                                          ONE_PROCESS_LOSS_ATOL[_kind(cfg)])
    del new_whole, grads
    reset_kernel_launches()
    for tokens in batches[1:]:
        local, opt, loss = step_fn(local, opt, torch.from_numpy(tokens))
        losses.append(loss.item())
    launches = {k: v + kernel_launches()[k] for k, v in launches.items()}
    return {"losses": losses, "launches": launches, "names": tree_names(local), "times": times,
            "one_process": one_process, "local": local}


def _free(device) -> None:
    """Give the finished config's memory back before the next one's."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _grow_rank_a(shape, device, jobs) -> dict:
    mesh = build_mesh(shape, device=device)
    outs = []
    for cfg, path, batches in jobs:
        params = init_params(cfg, torch.Generator().manual_seed(GROW_SEED), "cpu")
        out = grow_pack(mesh, cfg, params, batches, path)
        del out["state"], params
        _free(device)
        outs.append(out)
    return {"rank": mesh.rank, "configs": outs}


def _grow_rank_b(shape, device, jobs) -> dict:
    entered = time.time()
    mesh = build_mesh(shape, device=device)
    outs = []
    for cfg, path, batches in jobs:
        out = grow_restore(mesh, cfg, batches, path)
        del out["local"]
        _free(device)
        outs.append(out)
    return {"rank": mesh.rank, "entered": entered, "configs": outs}


def grow_checks(old_shape: tuple, new_shape: tuple, cfgs: list, paths: list, device="cuda", *,
                backend: str, steps: tuple = (2, 2), batch: tuple = DRYRUN_TOKENS,
                timeout_s: float = 600.0) -> dict:
    """``grow_check`` of each config of `cfgs` (its checkpoint at the same
    place in `paths`), the configs one after the other in the same two
    worlds: one spawn of old_shape's ranks packs and saves every config,
    then one spawn of new_shape's ranks restores and steps every config.
    Each config's steps, checks and batches are ``grow_check``'s. Returns
    {"configs": [{"old", "new"} of each config, as ``grow_check``'s],
    "start_s": world B's one start}."""
    if torch.device(device).type == "cuda":
        resolve_device(device)
    if min(steps) < 1:
        raise ValueError(f"steps {steps}: each world takes at least one step")
    if len(cfgs) != len(paths):
        raise ValueError(f"{len(cfgs)} configs, {len(paths)} checkpoint paths")
    batches = []
    for cfg in cfgs:
        rng = np.random.default_rng(GROW_SEED)
        batches.append([rng.integers(0, cfg.vocab, batch) for _ in range(sum(steps))])
    old = run_ranks(_grow_rank_a, math.prod(old_shape), backend=backend,
                    args=(tuple(old_shape), device,
                          [(c, p, b[:steps[0]]) for c, p, b in zip(cfgs, paths, batches)]),
                    timeout_s=timeout_s)
    spawned = time.time()
    new = run_ranks(_grow_rank_b, math.prod(new_shape), backend=backend,
                    args=(tuple(new_shape), device,
                          [(c, p, b[steps[0]:]) for c, p, b in zip(cfgs, paths, batches)]),
                    timeout_s=timeout_s)
    configs = []
    for i, cfg in enumerate(cfgs):
        worlds = {world: [{"rank": r["rank"], **r["configs"][i]} for r in results]
                  for world, results in (("old", old), ("new", new))}
        for world, results in worlds.items():
            if len({tuple(r["losses"]) for r in results}) != 1:
                raise RuntimeError(f"the {world} world's ranks' losses differ ({_kind(cfg)}): "
                                   f"{[r['losses'] for r in results]}")
        if worlds["old"][0]["names"] != worlds["new"][0]["names"]:
            raise RuntimeError(f"the worlds order the leaves differently ({_kind(cfg)}): "
                               f"{worlds['old'][0]['names']} against "
                               f"{worlds['new'][0]['names']}")
        configs.append(worlds)
    return {"configs": configs, "start_s": max(r["entered"] for r in new) - spawned}


def grow_check(old_shape: tuple, new_shape: tuple, device="cuda", *, backend: str, path: str,
               cfg: TransformerConfig | None = None, steps: tuple = (2, 2),
               batch: tuple = DRYRUN_TOKENS, timeout_s: float = 600.0) -> dict:
    """The hot-add that grows a training job's mesh: the port's form of the
    reference's ``test_hot_resume_grows_mesh`` (4 -> 8 chips), with the
    optimizer. A hot-add is a new process image in the port
    (``torchside.visibility.handoff``); for a job of several ranks that is
    a new world.

    1. World A: prod(old_shape) ranks (``parallel.launch.run_ranks``, a
       process group of `backend`) on an old_shape ("data", "model") mesh,
       each running ``grow_pack``: the seeded whole params of cfg
       (default ``check_config()``), steps[0] AdamW steps (lr 1e-3, weight
       decay 1e-4), the pack, rank 0's save to `path`. The processes exit.
    2. World B: prod(new_shape) ranks on a new_shape mesh, each running
       ``grow_restore``: load, restore its shards, hold them bit-equal,
       load the optimizer's state, steps[1] more steps, the first held
       against the one-process step.
    3. Every rank's losses equal in each world, and both worlds'
       ``tree_leaves`` order the same (the optimizer's state is keyed by
       it).

    Batches: numpy tokens of shape `batch` from seed GROW_SEED, one a
    step. The caller names the backend; nothing here swaps one for another.
    Runs on the card unless the caller passes device="cpu". Returns {"old":
    world A's per-rank results, "new": world B's, "start_s": host s from
    world B's spawn to its last rank's entry (processes, imports and the
    process group's set-up)}; raises when a check fails or a rank fails,
    naming it. ``grow_checks`` grows several configs in the same worlds."""
    out = grow_checks(old_shape, new_shape, [cfg if cfg is not None else check_config()],
                      [path], device, backend=backend, steps=steps, batch=batch,
                      timeout_s=timeout_s)
    return {**out["configs"][0], "start_s": out["start_s"]}


# --- the reference's multichip dryrun ---


def seq_mesh_shape(n: int) -> tuple[int, int]:
    """The dryrun's (data, seq) mesh for n ranks. The reference's is (dsp,
    n/dsp), dsp 2 for even n >= 4, else 1 (``__graft_entry__.py:207``);
    where n/dsp does not divide the 16 tokens of a row (n 3, 5, 6, 7) its
    section fails. There the port takes the largest seq axis that divides
    both n and 16, gcd(n, 16), and puts the rest on data: (3, 2) for n 6.
    ``seq_checks`` then runs the check batch's first rows that split over
    data (6 of 8 at n 6)."""
    dsp = 2 if n % 2 == 0 and n >= 4 else 1
    if DRYRUN_TOKENS[1] % (n // dsp) == 0:
        return dsp, n // dsp
    seq = math.gcd(n, DRYRUN_TOKENS[1])
    return n // seq, seq


def _section(name: str, fn, *args):
    """fn(*args); a failure is raised again naming the dryrun's section and
    this rank."""
    try:
        return fn(*args)
    except Exception as err:
        raise RuntimeError(f"dryrun section {name} failed on rank {dist.get_rank()}: "
                           f"{type(err).__name__}: {err}") from err


def _dryrun_rank(n: int, device) -> dict:
    out = {"rank": dist.get_rank()}
    out["tp"] = _section("tp_checks", lambda: tp_checks(build_mesh(device=device)))
    out["seq"] = _section("seq_checks", lambda: seq_checks(
        build_mesh(seq_mesh_shape(n), ("data", "seq"), device)))
    pipe = build_mesh((min(4, n),), ("pipe",), device)
    out["pipeline"] = None if pipe is None else _section("pipeline_checks", pipeline_checks, pipe)
    return out


def stretch_check(mesh, cfg: TransformerConfig, params: dict, tokens: torch.Tensor) -> dict:
    """The dryrun's stretch on this rank: one ``sharded_step_check`` of the
    whole `params` over `mesh`, its loss against the unsharded loss
    (``loss_fn`` of the whole params and batch in this one process) within
    SHARDED_LOSS_ATOL. Returns sharded_step_check's results with
    "loss_unsharded" and "loss_err"."""
    result = sharded_step_check(cfg, mesh, params, tokens)
    with torch.no_grad():
        ref = loss_fn(tree_map(lambda t: t.to(mesh.device), params), tokens.to(mesh.device),
                      cfg).item()
    err = abs(result["loss"] - ref)
    if not err < SHARDED_LOSS_ATOL:
        raise RuntimeError(f"rank {mesh.rank}: stretch loss {result['loss']} vs unsharded "
                           f"{ref} (|d|={err})")
    return {**result, "loss_unsharded": ref, "loss_err": err}


def _stretch_rank(plan, device) -> dict:
    mesh = build_mesh(plan.mesh_shape, plan.mesh_axes, device)
    cfg = _dryrun_config(mesh.device)
    params = init_params(cfg, torch.Generator().manual_seed(STRETCH["SEED"]), "cpu")
    result = _section("stretch", stretch_check, mesh, cfg, params, check_tokens(cfg))
    del result["local"]
    return {"rank": mesh.rank, "coords": dict(mesh.coords), **result}


def dryrun_multichip(n: int, device="cuda", *, backend: str, timeout_s: float = 600.0) -> dict:
    """The counterpart of the reference's ``dryrun_multichip(n)``
    (``__graft_entry__.py:110-336``), over processes joined by a process
    group of `backend`, in two spawns (``parallel.launch.run_ranks``), each
    with its own time limit.

    1. n ranks, each running the reference's sections on its meshes for n:
       ``tp_checks`` on ``build_mesh()`` (``mesh_shape_for(n)``: the dp x
       tp step, its grads through the kernels against the plain
       attention's, the MoE flagship, ``make_moe_step`` over (data,
       expert)); ``seq_checks`` on ``seq_mesh_shape(n)``; and
       ``pipeline_checks`` on a ("pipe",) mesh of the first min(4, n)
       ranks.
    2. The stretch: the reference's v5litepod-16 run, laid out by the H100
       plan ``topology.lookup("nvidia-h100-80gb", 16)``: 16 ranks on a (2,
       8) (data, model) mesh, hosts on data and a host's GPUs on model,
       each running ``stretch_check`` of ``_dryrun_config`` (seed 2).

    The reference's check against involuntary rematerialisation belongs to
    GSPMD's compiler; its counterpart is ``sharded_step_check``'s in every
    dp x tp step: the collectives of each step are ``step_collectives``',
    no weight is gathered, and the replicas are bit-equal.

    The caller names the backend; nothing here swaps one for another. Runs
    on the card unless the caller passes device="cpu". Returns {"sections":
    every rank's {"rank", "tp", "seq", "pipeline" (None outside the pipe
    mesh)}, "stretch": every rank's, "seq_shape", "pipe_stages", "plan",
    "seconds": {"sections", "stretch"} (host s of each spawn, the ranks'
    start included)}; raises, naming the section and the rank, when a
    check fails, and when a section's ranks' losses differ."""
    if torch.device(device).type == "cuda":
        resolve_device(device)
    t0 = time.perf_counter()
    sections = run_ranks(_dryrun_rank, n, backend=backend, args=(n, device),
                         timeout_s=timeout_s)
    t1 = time.perf_counter()
    plan = lookup(STRETCH["ACCEL"], STRETCH["GPUS"])
    stretch = run_ranks(_stretch_rank, plan.total_gpus, backend=backend, args=(plan, device),
                        timeout_s=timeout_s)
    t2 = time.perf_counter()
    for name, losses in (
            ("tp_checks", [r["tp"]["loss"] for r in sections]),
            ("seq_checks", [r["seq"]["loss"] for r in sections]),
            ("pipeline_checks", [r["pipeline"].get("loss") for r in sections
                                 if r["pipeline"] is not None]),
            ("stretch", [r["loss"] for r in stretch])):
        if len(set(losses)) != 1:
            raise RuntimeError(f"dryrun section {name}: the ranks' losses differ: {losses}")
    return {"sections": sections, "stretch": stretch, "seq_shape": seq_mesh_shape(n),
            "pipe_stages": min(4, n), "plan": plan,
            "seconds": {"sections": t1 - t0, "stretch": t2 - t1}}


# --- the one-node hot-mount (the control plane's add and remove flows) ---

#: the capability mknod(2) of a device node needs (linux/capability.h).
CAP_MKNOD = 27


def has_cap_mknod(status_path: str = "/proc/self/status") -> bool:
    """Is CAP_MKNOD in this process's effective set (CapEff)?"""
    with open(status_path) as f:
        for line in f:
            if line.startswith("CapEff:"):
                return bool(int(line.split()[1], 16) >> CAP_MKNOD & 1)
    raise RuntimeError(f"no CapEff line in {status_path}")


def pick_identity(procfs_dir: str = "/proc/driver/nvidia/gpus") -> str:
    """The identity source a host offers: the driver's procfs where it
    lists the GPUs, else NVML (a sandboxed driver may show no procfs)."""
    return "procfs" if os.path.isdir(procfs_dir) else "nvml"


def make_identity(name: str):
    return identity_from_config(Config(gpu_identity_source=name))


def _smi_gpus() -> list[dict]:
    out = subprocess.run(["nvidia-smi", "--query-gpu=index,uuid,pci.bus_id",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout
    gpus = []
    for line in out.strip().splitlines():
        index, uuid, pci = (x.strip() for x in line.split(","))
        gpus.append({"index": int(index), "uuid": uuid, "pci_bus_id": pci})
    return gpus


def inventory_check(identity: str, device_dir: str = "/dev") -> dict:
    """The live backend's inventory against nvidia-smi and stat(2): each
    GPU's NVML index, UUID and PCI bus id equal to nvidia-smi's ("[N/A]"
    there is "" here), and its node's and every companion's major:minor
    equal to os.stat's. Returns {"identity", "scan" (the NodeScan),
    "smi"}; raises on a mismatch."""
    backend = NvidiaDeviceBackend(device_dir, identity=make_identity(identity))
    scan = backend.scan()
    smi = {g["index"]: g for g in _smi_gpus()}
    if sorted(smi) != sorted(d.index for d in scan.devices):
        raise RuntimeError(f"GPUs listed {[d.index for d in scan.devices]} (identity "
                           f"{identity}), nvidia-smi lists {sorted(smi)}")
    for dev in scan.devices:
        want = smi[dev.index]
        want_pci = "" if want["pci_bus_id"] == "[N/A]" else want["pci_bus_id"]
        if dev.uuid != want["uuid"] or dev.pci_bus_id.lower() != want_pci.lower():
            raise RuntimeError(f"GPU {dev.index}: uuid/pci {dev.uuid} {dev.pci_bus_id!r} "
                               f"against nvidia-smi's {want['uuid']} {want['pci_bus_id']!r}")
        for path, major, minor in [(dev.device_path, dev.major, dev.minor)] + [
                (os.path.join(device_dir, c.rel_path), c.major, c.minor)
                for c in dev.companions]:
            st = os.stat(path)
            if (os.major(st.st_rdev), os.minor(st.st_rdev)) != (major, minor):
                raise RuntimeError(f"{path}: {major}:{minor} against stat's "
                                   f"{os.major(st.st_rdev)}:{os.minor(st.st_rdev)}")
    return {"identity": identity, "scan": scan, "smi": smi}


def busy_health_check(backend, dev, runs: int = 3) -> dict:
    """This process has CUDA open: the /proc scan must count it among the
    GPU's holders and find the holders the plain scan finds over the same
    processes, and the probe must find the GPU healthy. The two scans take
    turns, `runs` each (native, plain, plain, native, ...), the library
    loaded before. Returns {"holders", "scan_ms" and "plain_scan_ms" (the
    medians of full /proc scans, host clock), "scan_runs_ms",
    "plain_scan_runs_ms", "pids" (processes under /proc)}."""
    from gpumounter_tpu_torch import native
    from gpumounter_tpu_torch.device.backend import scan_proc_for_device_plain

    native.library()
    scans = [("native", lambda: backend.running_pids(dev)),
             ("plain", lambda: scan_proc_for_device_plain(dev.major, dev.minor,
                                                          path_hint=dev.device_path))]
    times = {"native": [], "plain": []}
    for i in range(runs):
        found = {}
        for kind, scan in scans if i % 2 == 0 else scans[::-1]:
            t0 = time.perf_counter()
            found[kind] = sorted(scan())
            times[kind].append((time.perf_counter() - t0) * 1e3)
        if found["native"] != found["plain"]:
            raise RuntimeError(f"the native /proc scan of {dev.device_path} found "
                               f"{found['native']}, the plain scan {found['plain']}")
    holders = found["native"]
    if os.getpid() not in holders:
        raise RuntimeError(f"the /proc scan of {dev.device_path} found holders {holders}, "
                           f"not this process ({os.getpid()}), which has CUDA open")
    healthy, why = backend.probe_device(dev)
    if not healthy:
        raise RuntimeError(f"probe_device of {dev.device_path}: unhealthy ({why})")
    pids = sum(1 for e in os.listdir("/proc") if e.isdigit())
    return {"holders": holders, "scan_ms": statistics.median(times["native"]),
            "plain_scan_ms": statistics.median(times["plain"]),
            "scan_runs_ms": times["native"], "plain_scan_runs_ms": times["plain"], "pids": pids}


def _released(cluster, pod, free_before: int) -> None:
    slaves = cluster.kube.list_pods(cluster.cfg.pool_namespace,
                                    label_selector=f"tpumounter.io/owner-uid={pod.uid}")
    if slaves or cluster.free_gpu_count() != free_before:
        raise RuntimeError(f"not released: slave pods {[Pod(s).name for s in slaves]}, "
                           f"{cluster.free_gpu_count()} GPU(s) free, {free_before} before")


def _check_nodes(backend, uuids: list[str], dev_dir: str, live: bool) -> None:
    """Each GPU's node and companions in `dev_dir`: character devices with
    the backend's numbers (a fake node may be a copy where mknod is
    refused)."""
    for uuid in uuids:
        dev = backend.device_by_uuid(uuid)
        for name, major, minor in [(dev.basename, dev.major, dev.minor)] + [
                (c.rel_path, c.major, c.minor) for c in dev.companions]:
            st = os.stat(os.path.join(dev_dir, name))
            if statmod.S_ISCHR(st.st_mode):
                if (os.major(st.st_rdev), os.minor(st.st_rdev)) != (major, minor):
                    raise RuntimeError(f"injected {name}: {os.major(st.st_rdev)}:"
                                       f"{os.minor(st.st_rdev)}, the GPU's {major}:{minor}")
            elif live or not statmod.S_ISREG(st.st_mode):
                raise RuntimeError(f"injected {name} is not a character device")


def _live_target(root: str, dev_dir: str | None, cgroup_dirs) -> tuple[str, list]:
    """The live flows' tenant directory (`dev_dir`, else a new one under
    `root`) and cgroup directories (`cgroup_dirs`, else a stand-in of the v1
    files with no process in it)."""
    target = dev_dir or os.path.join(root, "tenant-dev")
    os.makedirs(target, exist_ok=True)
    if not cgroup_dirs:
        cgroup_dirs = [os.path.join(root, "cgroup")]
        os.makedirs(cgroup_dirs[0])
        for name in ("cgroup.procs", "devices.allow", "devices.deny"):
            open(os.path.join(cgroup_dirs[0], name), "w").close()
    return target, list(cgroup_dirs)


def _mount_flow(cluster, service, dev_dir: str, n: int, repeats: int, expect: str,
                on_mounted=None, live: bool = False) -> dict:
    """`repeats` times: add_gpu(n) into a target pod, then (when it
    mounted) remove_gpu, each checked; `expect` is "round-trip" or
    "refused" (the mknod refusal naming CAP_MKNOD, with the allocation
    rolled back). on_mounted(uuids, dev_dir) runs once, while mounted."""
    pod = cluster.add_target_pod(f"tenant-{n}")
    free = cluster.free_gpu_count()
    out = {"case": expect, "n": n, "add_ms": [], "remove_ms": [], "uuids": None,
           "refusal": None, "add_phases_ms": None, "remove_phases_ms": None}
    for i in range(repeats):
        t0 = time.perf_counter()
        try:
            added = service.add_gpu(AddGPURequest(pod.name, pod.namespace, n))
        except ServiceError as exc:
            out["add_ms"].append((time.perf_counter() - t0) * 1e3)
            if expect != "refused" or "CAP_MKNOD" not in exc.message:
                raise
            _released(cluster, pod, free)
            out["refusal"] = exc.message
            continue
        out["add_ms"].append((time.perf_counter() - t0) * 1e3)
        if added.add_gpu_result != AddGPUResult.Success or len(added.uuids) != n:
            raise RuntimeError(f"add_gpu({n}): {added}")
        if expect == "refused":
            raise RuntimeError(f"add_gpu({n}) mounted {added.uuids} without CAP_MKNOD")
        _check_nodes(cluster.backend, added.uuids, dev_dir, live)
        if cluster.free_gpu_count() != free - n:
            raise RuntimeError(f"{cluster.free_gpu_count()} GPU(s) free after add_gpu({n}), "
                               f"{free} before")
        if on_mounted is not None and i == 0:
            on_mounted(added.uuids, dev_dir)
        t0 = time.perf_counter()
        removed = service.remove_gpu(RemoveGPURequest(pod.name, pod.namespace, added.uuids))
        out["remove_ms"].append((time.perf_counter() - t0) * 1e3)
        if removed.remove_gpu_result != RemoveGPUResult.Success:
            raise RuntimeError(f"remove_gpu({added.uuids}): {removed}")
        for uuid in added.uuids:
            if os.path.lexists(os.path.join(dev_dir, cluster.backend.device_by_uuid(uuid).basename)):
                raise RuntimeError(f"{uuid}'s node still in {dev_dir} after remove_gpu")
        _released(cluster, pod, free)
        out.update(uuids=added.uuids, add_phases_ms=added.phases_ms,
                   remove_phases_ms=removed.phases_ms)
    return out


def mount_check(device="cuda", *, dev_dir: str | None = None, ns_pid: int | None = None,
                cgroup_dirs=(), identity: str = "nvml", fake_gpus: int = 8,
                repeats: int = 3, on_mounted=None) -> dict:
    """The worker's add and remove flows in process (``GpuMountService``
    over a ``FakeCluster``), checked and timed.

    On the card (device="cuda"): over the live ``NvidiaDeviceBackend`` on
    /dev (identity "nvml" or "procfs"), add_gpu(1) into `dev_dir` (a new
    temporary directory when None), entering the mount namespace of
    `ns_pid` when given and granting on `cgroup_dirs` (cgroup v1; when
    empty, a stand-in directory of the v1 files with no process in it: the
    caller holds the card open, and a target without a cgroup would count
    it among the GPU's holders, so remove_gpu would answer GPUBusy and a
    rollback would kill the caller): with
    CAP_MKNOD the GPU's node and companions must land as character devices
    with its numbers, then remove_gpu must take the node away and release
    the slave pod; without it add_gpu must fail with the refusal naming
    CAP_MKNOD and roll the allocation back. on_mounted(uuids, dev_dir)
    runs once while the GPU is mounted. Then, as with device="cpu", the
    same flows of 1 and of `fake_gpus` GPUs on a ``FakeDeviceBackend`` of
    `fake_gpus`. Runs on the card unless the caller passes device="cpu".

    Returns {"live": the flow's report (card only), "cap_mknod", "fake":
    {n: report}}; a report holds the case, add_ms and remove_ms (host
    clock, each repeat), the UUIDs mounted, the refusal, and the last
    flow's phase timings."""
    device = resolve_device(device)
    report = {"cap_mknod": has_cap_mknod()}
    root = tempfile.mkdtemp(prefix="mount-check-")
    try:
        if device.type == "cuda":
            cluster = FakeCluster(NvidiaDeviceBackend("/dev", identity=make_identity(identity)))
            target, cgroup_dirs = _live_target(root, dev_dir, cgroup_dirs)
            service = cluster.service(target, ns_pid=ns_pid, cgroup_dirs=cgroup_dirs)
            expect = "round-trip" if report["cap_mknod"] else "refused"
            report["live"] = _mount_flow(cluster, service, target, 1, repeats, expect,
                                         on_mounted=on_mounted, live=True)
        fake = FakeCluster.with_fake_gpus(os.path.join(root, "fake"), fake_gpus)
        fake_dir = os.path.join(root, "fake-tenant-dev")
        os.makedirs(fake_dir)
        service = fake.service(fake_dir)
        report["fake"] = {n: _mount_flow(fake, service, fake_dir, n, repeats, "round-trip")
                          for n in sorted({1, fake_gpus})}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return report


# --- the cgroup v2 device controller ---

_CHAR = ebpf.BPF_DEVCG_DEV_CHAR
_RW = ebpf.BPF_DEVCG_ACC_READ | ebpf.BPF_DEVCG_ACC_WRITE
# The stand-in host of the CPU: nvidia0, nvidiactl, and an nvidia-uvm whose
# major is dynamic on a real host (any number will do).
_CPU_NODES = (("nvidia0", 195, 0), ("nvidiactl", 195, 255), ("nvidia-uvm", 511, 0))


def _cpu_gpu(root: str) -> GpuDevice:
    """A GPU of the stand-in host: char nodes with no driver behind them,
    made under `root` (mknod needs CAP_MKNOD)."""
    os.makedirs(root)
    for name, major, minor in _CPU_NODES:
        os.mknod(os.path.join(root, name), 0o666 | statmod.S_IFCHR, os.makedev(major, minor))
    (name, major, minor), companions = _CPU_NODES[0], _CPU_NODES[1:]
    return GpuDevice(index=0, device_path=os.path.join(root, name), major=major, minor=minor,
                     uuid="GPU-00000000-0000-0000-0000-000000000000",
                     companions=[CompanionNode(*c) for c in companions])


def _node_paths(gpu: GpuDevice) -> list[str]:
    base = os.path.dirname(gpu.device_path)
    return [gpu.device_path] + [os.path.join(base, c.rel_path) for c in gpu.companions]


def _neighbour(gpu: GpuDevice) -> tuple[int, int]:
    """A minor of the GPU's major that is neither the GPU nor a companion."""
    taken = {(c.major, c.minor) for c in gpu.companions} | {(gpu.major, gpu.minor)}
    return next((gpu.major, m) for m in (gpu.minor + 1, gpu.minor - 1, gpu.minor + 2)
                if m >= 0 and (gpu.major, m) not in taken)


def _v2_program_us(gpu: GpuDevice, iters: int = 200) -> dict:
    """Host µs to assemble the program for this GPU: the static rule set
    (defaults + the GPU's group, the legacy path), and the map path's
    (defaults, the telemetry and policy blocks)."""
    rules = list(ebpf.DEFAULT_CONTAINER_RULES) + [ebpf.device_rule(gpu)] + [
        ebpf.DeviceRule("c", c.major, c.minor, "rw") for c in gpu.companions]
    out = {}
    for name, build in (("static", lambda: ebpf.build_device_program(rules)),
                        ("maps", lambda: ebpf.build_device_program(
                            ebpf.DEFAULT_CONTAINER_RULES, telemetry_map_fd=3, policy_map_fd=4))):
        t0 = time.perf_counter()
        for _ in range(iters):
            prog = build()
        out[name] = (time.perf_counter() - t0) * 1e6 / iters
        out[f"{name}_insns"] = len(prog) // ebpf.INSN_SIZE
    return out


def _v2_stub_flow(gpu: GpuDevice, root: str, maps: bool) -> dict:
    """A grant and the last revoke of `gpu` through ``V2DeviceController`` on
    the stubbed kernel, runc's default program attached first, every
    verdict from ``interpret_device_program`` over the attached programs:
    after the grant rw on the GPU and each companion is admitted and a
    neighbouring minor denied; after the revoke runc's program is back
    alone and the GPU and the companions are denied. Returns the verdicts
    and the grant's and revoke's host ms."""
    kernel = FakeBpf(maps=maps)
    tag = "maps" if maps else "legacy"
    cgroup = os.path.join(root, f"stub-cgroup-{tag}")
    os.makedirs(cgroup)
    kernel.preattach(cgroup, 7, ebpf.build_device_program(ebpf.DEFAULT_CONTAINER_RULES))
    targets = [(gpu.major, gpu.minor)] + [(c.major, c.minor) for c in gpu.companions]

    def verdicts():
        return [kernel.verdict(interpret_device_program, cgroup, _CHAR, _RW, *t) for t in targets]

    with kernel.installed(ebpf):
        ctl = ebpf.V2DeviceController(pin_dir=os.path.join(root, f"stub-{tag}", "bpffs"),
                                      state_dir=os.path.join(root, f"stub-{tag}", "state"))
        try:
            t0 = time.perf_counter()
            ctl.grant_many(cgroup, [gpu], tenant="cgroup-v2-check")
            grant_ms = (time.perf_counter() - t0) * 1e3
            granted = verdicts()
            neighbour = kernel.verdict(interpret_device_program, cgroup, _CHAR, _RW,
                                       *_neighbour(gpu))
            t0 = time.perf_counter()
            ctl.revoke(cgroup, gpu)
            revoke_ms = (time.perf_counter() - t0) * 1e3
            revoked = verdicts()
        finally:
            ctl.close()
    if granted != [1] * len(targets) or neighbour != 0 or revoked != [0] * len(targets) \
            or kernel.attached[os.path.realpath(cgroup)] != [7]:
        raise RuntimeError(f"cgroup v2 ({tag}, stubbed kernel): granted {granted}, neighbour "
                           f"{neighbour}, revoked {revoked}, attached "
                           f"{kernel.attached[os.path.realpath(cgroup)]}")
    return {"granted": granted, "neighbour": neighbour, "revoked": revoked,
            "grant_ms": grant_ms, "revoke_ms": revoke_ms}


def _ask(child, command: str) -> dict:
    child.stdin.write(command + "\n")
    child.stdin.flush()
    line = child.stdout.readline()
    if not line:
        raise RuntimeError(f"the tenant exited ({child.wait()}) on {command!r}")
    return json.loads(line)


def _v2_kernel_flow(gpu: GpuDevice, root: str, tenant_argv: list, tenant_env) -> dict:
    """The round trip on the kernel, in a child of the cgroup2 mounted at
    <root>/cgroup2 with bpffs at <root>/bpffs: runc's default program
    attached; a tenant child in that cgroup denied the GPU's node (EPERM);
    ``grant_many``; the same child opens the GPU's node and companions
    (admitted: ok, or ENXIO/ENODEV with no driver behind a node) and runs
    its workload; a restarted controller restores the grant from the pins
    and the journal and revokes it; ``prog_query`` gives the ids from
    before the grant; the child is denied again. Any failure raises."""
    cgroup = v2tenant.check_cgroup(os.path.join(root, "cgroup2"), "v2-check")
    cg_fd = runc_fd = child = None
    controllers = []
    paths = _node_paths(gpu)
    out = {"paths": paths}
    try:
        os.mkdir(cgroup)
        cg_fd = os.open(cgroup, os.O_RDONLY | os.O_DIRECTORY)
        runc_fd = ebpf.prog_load(ebpf.build_device_program(ebpf.DEFAULT_CONTAINER_RULES))
        ebpf.prog_attach(cg_fd, runc_fd)
        out["ids_before"] = ebpf.prog_query(cg_fd)
        state = dict(pin_dir=os.path.join(root, "bpffs"), state_dir=os.path.join(root, "state"))
        controllers.append(ebpf.V2DeviceController(**state))
        child = subprocess.Popen(tenant_argv + [json.dumps({"cgroup": cgroup, "paths": paths})],
                                 stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
                                 env=tenant_env)
        if "ready" not in json.loads(child.stdout.readline() or "{}"):
            raise RuntimeError(f"the tenant did not join {cgroup} ({child.wait()})")
        out["before"] = _ask(child, "open")["open"]
        t0 = time.perf_counter()
        controllers[0].grant_many(cgroup, [gpu], tenant="cgroup-v2-check")
        out["grant_ms"] = (time.perf_counter() - t0) * 1e3
        out["ids_granted"] = ebpf.prog_query(cg_fd)
        out["granted"] = _ask(child, "open")["open"]
        t0 = time.perf_counter()
        out["run"] = _ask(child, "run")["run"]
        out["run_ms"] = (time.perf_counter() - t0) * 1e3
        controllers.append(ebpf.V2DeviceController(**state))  # a restarted worker
        out["restored"] = {os.path.basename(cg): sorted(g)
                           for cg, g in controllers[1].enumerate_grants().items()}
        t0 = time.perf_counter()
        controllers[1].revoke(cgroup, gpu)
        out["revoke_ms"] = (time.perf_counter() - t0) * 1e3
        out["ids_after"] = ebpf.prog_query(cg_fd)
        out["after"] = _ask(child, "open")["open"]
        child.stdin.write("exit\n")
        child.stdin.flush()
        out["tenant_exit"] = child.wait(timeout=60)
        # bpffs shows its own "maps.debug" and "progs.debug"; a pin never
        # has a dot in its name
        out["pins_left"] = sorted(p for p in os.listdir(state["pin_dir"]) if "." not in p)
    finally:
        if child is not None and child.poll() is None:
            child.kill()
            child.wait()
        for ctl in controllers:
            ctl.close()
        if cg_fd is not None and set(out.get("ids_before", ())) & set(ebpf.prog_query(cg_fd)):
            ebpf.prog_detach(cg_fd, runc_fd)
        for fd in (runc_fd, cg_fd):
            if fd is not None:
                os.close(fd)
        if os.path.isdir(cgroup):
            os.rmdir(cgroup)
    denied = out["before"][gpu.device_path] == "EPERM" == out["after"][gpu.device_path]
    admitted = all(v in v2tenant.ADMITTED for v in out["granted"].values())
    swapped = (len(out["ids_granted"]) == 1 and out["ids_granted"] != out["ids_before"])
    restored = out["restored"] == {os.path.basename(cgroup): [(gpu.major, gpu.minor)]}
    if not (denied and admitted and swapped and restored and out["ids_after"] == out["ids_before"]
            and out["tenant_exit"] == 0 and out["pins_left"] == []):
        raise RuntimeError(f"cgroup v2 on the kernel: {out}")
    return out


def cgroup_v2_check(device="cuda", *, identity: str = "nvml", tenant_argv=None,
                    tenant_env=None) -> dict:
    """The cgroup v2 device controller on this host's GPU: its inventory
    (on the card the live ``NvidiaDeviceBackend``'s first GPU, its numbers
    from stat(2); on the CPU a stand-in host of char nodes with no driver,
    made with mknod); the program's assembly, timed; a grant and the last
    revoke through ``V2DeviceController`` on the stubbed kernel, on both
    paths, checked by the interpreter (``_v2_stub_flow``); the kernel
    probed (``ebpf.kernel_probe``). Where all four probes answer "ok", the
    round trip runs on the kernel (``_v2_kernel_flow``) with a tenant child
    started as `tenant_argv` + [spec] (default: ``testing/v2tenant.py``,
    no workload) in `tenant_env`; any failure there raises. Where one does
    not, its errno is reported and nothing more is tried. Runs on the card
    unless the caller passes device="cpu".

    Returns {"gpu", "assembly_us", "stub": {"legacy", "maps"}, "probe",
    "branch" ("kernel" or "probe refused"), "kernel" (the round trip's
    report, or None)}."""
    device = resolve_device(device)
    root = tempfile.mkdtemp(prefix="cgroup-v2-check-")
    mounted = []
    try:
        if device.type == "cuda":
            gpu = NvidiaDeviceBackend("/dev", identity=make_identity(identity)).list_devices()[0]
        else:
            gpu = _cpu_gpu(os.path.join(root, "dev"))
        report = {"gpu": gpu, "assembly_us": _v2_program_us(gpu),
                  "stub": {"legacy": _v2_stub_flow(gpu, root, maps=False),
                           "maps": _v2_stub_flow(gpu, root, maps=True)}}
        probe = report["probe"] = ebpf.kernel_probe(root)
        mounted = [os.path.join(root, name) for name in ("bpffs", "cgroup2")
                   if probe[f"{name}_mount"] == "ok"]
        report["kernel"] = None
        report["branch"] = "kernel" if set(probe.values()) == {"ok"} else "probe refused"
        if report["branch"] == "kernel":
            argv = tenant_argv or [sys.executable, "-m", "gpumounter_tpu_torch.testing.v2tenant"]
            report["kernel"] = _v2_kernel_flow(gpu, root, argv, tenant_env)
    finally:
        for target in mounted:
            ebpf.unmount(target)
        shutil.rmtree(root, ignore_errors=True)
    return report


# --- the master's flows over HTTP ---

def _http(base: str, method: str, path: str, token: str | None, form: dict | None = None,
          payload=None) -> tuple[int, str, float]:
    """(status, body, ms on the host clock) of one request, its body the
    url-encoded `form` or the JSON of `payload`."""
    return _http_with_headers(base, method, path, token, form, payload)[:3]


def _http_with_headers(base: str, method: str, path: str, token: str | None,
                       form: dict | None = None, payload=None,
                       accept: str = "") -> tuple[int, str, float, dict]:
    """``_http``'s answer and the response's headers; `accept`, the
    request's Accept header."""
    headers = {"Authorization": f"Bearer {token}"} if token else {}
    if accept:
        headers["Accept"] = accept
    data = urllib.parse.urlencode(form, doseq=True).encode() if form is not None else None
    if payload is not None:
        data = json.dumps(payload).encode()
        headers["Content-Type"] = "application/json"
    req = urllib.request.Request(base + path, data=data, method=method, headers=headers)
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            status, body, got = resp.status, resp.read().decode(), dict(resp.headers)
    except urllib.error.HTTPError as exc:
        status, body, got = exc.code, exc.read().decode(), dict(exc.headers)
    return status, body, (time.perf_counter() - t0) * 1e3, got


def _add_path(pod, n: int) -> str:
    return f"/addgpu/namespace/{pod.namespace}/pod/{pod.name}/gpu/{n}/isEntireMount/false"


def _remove_path(pod) -> str:
    return f"/removegpu/namespace/{pod.namespace}/pod/{pod.name}/force/false"


class _MasterStack:
    """The master's HTTP API on 127.0.0.1 in front of one gRPC worker server
    a node of `cluster`, each node's kubelet over gRPC, mounting into
    `dev_dirs[node]`. Node i's worker registers at 10.0.0.<i + 1>; every
    server listens on 127.0.0.1, so the master's worker_client_factory and
    its telemetry_client_factory are its default clients with a registered
    IP mapped to its server's port; the mount path's breaker keys a worker
    by its registered address, as the master's gate and the fleet
    collector read it. ``restart(node)`` replaces a node's worker by a new
    one over the same ledger, as after its death, ``spawn(node, ...)`` by a
    child process, and ``kill(node)`` is its death. Stops all it started on
    exit.

    With `replicas` > 0 the master is that many sharded replicas
    (``apps``, ``bases``; ``app`` and ``base`` are replica 0's): shard_count
    `replicas`, replica i named m-<i> and volunteering for shard i, each
    with its own HTTP server as its advertised URL, `shard_cfg` over the
    cluster's config (the lease's duration, the admission gate). With
    `renew_loop` each ShardManager runs its renew thread (``start``), as
    ``master/main.py`` starts it, replica i once replica i - 1 holds its
    shard, and the stack is ready when every replica holds its shard and
    routes every node; without it they are active without a loop and the
    caller drives ``acquire``. On exit each stops with release, then its
    app closes, as in ``master/main.py``."""

    def __init__(self, cluster: FakeCluster, dev_dirs: dict[str, str], ns_pid: int | None = None,
                 cgroup_dirs=(), replicas: int = 0, shard_cfg: dict | None = None,
                 renew_loop: bool = False):
        self.cluster, self.token = cluster, cluster.cfg.auth_token
        self.cfg = (dataclasses.replace(cluster.cfg, shard_count=replicas, shard_preferred="",
                                        **(shard_cfg or {})) if replicas else cluster.cfg)
        self.dev_dirs, self.ns_pid, self.cgroup_dirs = dev_dirs, ns_pid, cgroup_dirs
        self.api: FakeApiServer | None = None  # the stand-in API of spawn's processes
        self.workers = WorkerServers(self._service)
        self.services = self.workers.services
        for i, node in enumerate(cluster.node_names):
            self.workers.start(node, f"10.0.0.{i + 1}")
            cluster.register_worker(self.workers.ip_by_node[node], node=node)
        self.apps, self.httpds, self.bases = [], [], []
        for i in range(max(1, replicas)):
            shards = (ShardManager(cluster.kube, cfg=self.cfg, replica_id=f"m-{i}",
                                   preferred={i}) if replicas else None)
            app = MasterApp(cluster.kube, cfg=self.cfg, shards=shards,
                            worker_client_factory=lambda address, i=i: WorkerClient(
                                self.workers.local_address(address), token=self.token,
                                cfg=self.cfg, breaker=self.apps[i].registry.breaker,
                                channel_pool=self.apps[i].registry.channel_pool,
                                breaker_key=address),
                            telemetry_client_factory=lambda address: WorkerClient(
                                self.workers.local_address(address), token=self.token,
                                cfg=self.cfg))
            httpd = build_http_server(app, port=0, host="127.0.0.1")
            threading.Thread(target=httpd.serve_forever, name="master-http",
                             daemon=True).start()
            self.apps.append(app)
            self.httpds.append(httpd)
            self.bases.append(f"http://127.0.0.1:{httpd.server_address[1]}")
            if replicas:
                shards.advertise_url = self.bases[-1]
                if not renew_loop:
                    shards.start_without_loop()
        self.app, self.httpd, self.base = self.apps[0], self.httpds[0], self.bases[0]
        if replicas and renew_loop:
            self._start_renew_loops()
        elif replicas:
            self.acquire(2)  # each its own shard, then the peers' for redirects

    def _start_renew_loops(self) -> None:
        deadline = time.monotonic() + 2 * self.apps[0].shards.renew_interval_s + 5.0

        def wait(what: str, ready) -> None:
            while not ready():
                if time.monotonic() > deadline:
                    raise RuntimeError(f"the replicas' renew loops: {what} not reached, "
                                       f"tables {[a.shards.table() for a in self.apps]}")
                time.sleep(0.01)

        for i, app in enumerate(self.apps):
            app.shards.start()
            wait(f"replica {i} holding shard {i}",
                 lambda i=i, app=app: i in app.shards.owned_shards())
        wait("every node routed by every replica",
             lambda: all(app.shards.route(node)[0] != "unowned" for app in self.apps
                         for node in self.cluster.node_names))

    def acquire(self, passes: int = 1) -> None:
        """`passes` lease passes of every replica, in turn."""
        for _ in range(passes):
            for app in self.apps:
                app.shards.acquire_once()

    def owner(self, node: str) -> int:
        """The index of the replica that owns `node`."""
        return next(i for i, app in enumerate(self.apps) if app.shards.owns_node(node))

    def _service(self, node: str):
        return self.cluster.service(self.dev_dirs[node], ns_pid=self.ns_pid,
                                    cgroup_dirs=self.cgroup_dirs, kubelet="grpc", node=node)

    def restart(self, node: str) -> tuple[dict, float]:
        """``WorkerServers.restart`` of the node, the master's pooled channel
        to the old server dropped."""
        return self.workers.restart(node, self.app.registry.channel_pool)

    def client(self, node: str):
        return self.app._client_factory(self.app.registry.worker_address(node))

    def spawn(self, node: str, workdir: str, **cfg_fields) -> WorkerProcess:
        """The node's worker becomes a child process
        (``testing.worker_process``): the node's mounter and kubelet socket,
        the node's config with `cfg_fields` (its backend's), no warm pool,
        a ledger under `workdir`, and the cluster's API through a stand-in
        API server (started at the first call, its certificate in
        `workdir`). The in-process worker drains its warm pool (its holders
        released) and stops; each master's channel to it serves no more."""
        if self.api is None:
            tls = selfsigned(workdir)
            if tls is None:
                raise RuntimeError("a worker process needs openssl: the stand-in API server's "
                                   "certificate")
            self.api, self._api_ca = FakeApiServer(self.cluster.kube, *tls).start(), tls[0]
        service = self.services[node]
        if service.pool is not None:
            service.pool.set_drained(node, True)
            service.pool.stop()
        cfg = dataclasses.replace(
            service.cfg, warm_pool_size=0, ledger_dir=os.path.join(workdir, f"ledger-{node}"),
            kubelet_socket=self.cluster.serve_kubelet(node).socket_path, **cfg_fields)
        child = WorkerProcess({"cfg": dataclasses.asdict(cfg),
                               "api": {"port": self.api.port, "token": self.api.token,
                                       "ca": self._api_ca},
                               "dev_dir": self.dev_dirs[node], "ns_pid": self.ns_pid,
                               "cgroup_dirs": list(self.cgroup_dirs)},
                              os.path.join(workdir, f"worker-{node}.log"))
        self.workers.adopt(node, child, child.port,
                           [app.registry.channel_pool for app in self.apps])
        return child

    def kill(self, node: str) -> None:
        """The node's worker dies, as the control plane sees it
        (``WorkerServers.kill``: a worker process is killed with SIGKILL),
        and its in-process warm pool stops."""
        self.workers.kill(node, self.cluster.kube, self.cfg,
                          [app.registry.channel_pool for app in self.apps])
        service = self.services[node]
        if service.pool is not None:
            service.pool.stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for httpd, app in zip(self.httpds, self.apps):
            httpd.shutdown()
            httpd.server_close()
            if app.shards.active():
                app.shards.stop(release=True)
            app.close()
        self.workers.stop()
        if self.api is not None:
            self.api.stop()
        self.cluster.stop()
        return False

    def http(self, method: str, path: str, form: dict | None = None, token: str | None = "",
             payload=None) -> tuple[int, str, float]:
        return _http(self.base, method, path, self.token if token == "" else token, form,
                     payload)

    def traced(self, method: str, path: str, form: dict | None = None,
               payload=None) -> tuple[int, str, float, str]:
        """``http``'s answer and the trace id the master sent back."""
        status, body, ms, headers = _http_with_headers(self.base, method, path, self.token,
                                                       form, payload)
        tid = next((v for k, v in headers.items() if k.lower() == trace.TRACE_HEADER), "")
        return status, body, ms, tid

    def held(self, node: str, pod) -> list[str]:
        return [d.uuid for d in
                self.services[node].collector.get_pod_devices(pod.name, pod.namespace)]

    def call_ms(self, repeats: int) -> list[float]:
        """The worker call alone, `repeats` times: AddGPU of a pod that does
        not exist (PodNotFound), over this stack's client, host clock."""
        address = self.app.registry.worker_address(self.cluster.node_name)
        out = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            with self.app._client_factory(address) as client:
                result = client.add_gpu("no-such-pod", "default", 1).add_gpu_result
            out.append((time.perf_counter() - t0) * 1e3)
            if result != AddGPUResult.PodNotFound:
                raise RuntimeError(f"AddGPU of a missing pod over gRPC: {result}")
        return out


def _master_flow(stack: _MasterStack, dev_dir: str, n: int, repeats: int, expect: str,
                 on_mounted=None, live: bool = False) -> dict:
    """`repeats` times: GET /addgpu/.../gpu/`n` into a target pod, then (when
    it mounted) POST /removegpu/... with its UUIDs, each answer and its
    effect checked; `expect` is "round-trip" or "refused" (500 naming
    CAP_MKNOD, the allocation rolled back). on_mounted(uuids, dev_dir) runs
    once, while mounted."""
    cluster = stack.cluster
    service = stack.services[cluster.node_name]
    pod = cluster.add_target_pod(f"tenant-http-{n}")
    free = cluster.free_gpu_count()
    out = {"case": expect, "n": n, "add_ms": [], "remove_ms": [], "uuids": None,
           "refusal": None}
    for i in range(repeats):
        status, body, ms = stack.http("GET", _add_path(pod, n))
        out["add_ms"].append(ms)
        if expect == "refused":
            if status != 500 or "CAP_MKNOD" not in body:
                raise RuntimeError(f"add of {n} without CAP_MKNOD: {status} {body!r}")
            _released(cluster, pod, free)
            out["refusal"] = body.strip()
            continue
        if (status, body) != (200, "Add GPU Success\n"):
            raise RuntimeError(f"GET {_add_path(pod, n)}: {status} {body!r}")
        uuids = [d.uuid for d in service.collector.get_pod_devices(pod.name, pod.namespace)]
        if len(uuids) != n:
            raise RuntimeError(f"{len(uuids)} GPU(s) held after the add of {n}: {uuids}")
        _check_nodes(cluster.backend, uuids, dev_dir, live)
        if cluster.free_gpu_count() != free - n:
            raise RuntimeError(f"{cluster.free_gpu_count()} GPU(s) free after the add of {n}, "
                               f"{free} before")
        if on_mounted is not None and i == 0:
            on_mounted(uuids, dev_dir)
        status, body, ms = stack.http("POST", _remove_path(pod), {"uuids": ",".join(uuids)})
        out["remove_ms"].append(ms)
        if (status, body) != (200, f"Remove {n} GPUs Success\n"):
            raise RuntimeError(f"POST {_remove_path(pod)} {uuids}: {status} {body!r}")
        for uuid in uuids:
            if os.path.lexists(os.path.join(dev_dir,
                                            cluster.backend.device_by_uuid(uuid).basename)):
                raise RuntimeError(f"{uuid}'s node still in {dev_dir} after the remove")
        _released(cluster, pod, free)
        out["uuids"] = uuids
    return out


def _master_errors(stack: _MasterStack, dev_dir: str) -> dict:
    """The error mapping against the stack's node: more GPUs than it has
    (500 Insufficient, nothing mounted, nothing left booked), a pod that
    does not exist (404), a UUID it does not hold (400 Invalid UUIDs), no
    token (401). Returns {case: (status, first line of the body)}."""
    cluster = stack.cluster
    pod = cluster.add_target_pod("tenant-http-errors")
    free = cluster.free_gpu_count()
    before = sorted(os.listdir(dev_dir))
    want = {"insufficient": (500, "Insufficient GPU on Node: " + cluster.node_name),
            "no pod": (404, "No pod: ghost in namespace: default"),
            "unknown uuid": (400, "Invalid UUIDs: GPU-not-here"),
            "no token": (401, "missing or invalid bearer token")}
    ghost = Pod({"metadata": {"name": "ghost", "namespace": "default"}})
    got = {"insufficient": stack.http("GET", _add_path(pod, len(cluster.assignment) + 1)),
           "no pod": stack.http("GET", _add_path(ghost, 1)),
           "unknown uuid": stack.http("POST", _remove_path(pod), {"uuids": "GPU-not-here"}),
           "no token": stack.http("GET", _add_path(pod, 1), token=None)}
    got = {k: (status, body.strip()) for k, (status, body, _) in got.items()}
    if got != want:
        raise RuntimeError(f"the master's error mapping: {got}, expected {want}")
    if sorted(os.listdir(dev_dir)) != before:
        raise RuntimeError(f"the refused calls left {sorted(os.listdir(dev_dir))} in {dev_dir}")
    _released(cluster, pod, free)
    return got


def _codec_ms(iters: int = 2000) -> float:
    """One AddGPU and one RemoveGPU exchange through the wire codec (each
    request and response encoded and decoded), host clock, averaged."""
    add_req = AddGPURequest("tenant", "default", 1, False, "add-0123456789abcdef")
    add_resp = AddGPUResponse(AddGPUResult.Success, ["GPU-00000000-1111-2222-3333-444444444444"])
    rm_req = RemoveGPURequest("tenant", "default", add_resp.uuids, idempotency_key="rm-01234567")
    rm_resp = RemoveGPUResponse(RemoveGPUResult.Success)
    t0 = time.perf_counter()
    for _ in range(iters):
        for msg in (add_req, add_resp, rm_req, rm_resp):
            type(msg).decode(msg.encode())
    return (time.perf_counter() - t0) * 1e3 / iters


def master_check(device="cuda", *, dev_dir: str | None = None, ns_pid: int | None = None,
                 cgroup_dirs=(), identity: str = "nvml", fake_gpus: int = 8,
                 repeats: int = 3, on_mounted=None) -> dict:
    """The master's flows over HTTP: ``MasterApp`` on
    ``build_http_server(port=0, host="127.0.0.1")``, routing to the node's
    ``GpuMountService`` over gRPC (the worker's gRPC server, the kubelet
    over gRPC). Without grpcio it raises ``ModuleNotFoundError`` naming
    grpcio.

    On the card (device="cuda"): a ``FakeCluster`` over the live
    ``NvidiaDeviceBackend`` (as ``mount_check`` wires it: `dev_dir`,
    `ns_pid`, `cgroup_dirs`, `identity`); GET /addgpu/.../gpu/1/
    isEntireMount/false, the node checked in the tenant directory and
    on_mounted(uuids, dev_dir) called once; POST /removegpu/.../force/false
    with the UUID, the node gone and the slave pod released (without
    CAP_MKNOD: the add answers 500 naming it, rolled back); then the error
    mapping on the live host (gpu/2 on one card 500 Insufficient, an unknown
    pod 404, an unknown UUID 400, no token 401). On both devices: the flows
    of 1 and of `fake_gpus` GPUs and the error mapping on a fake host of
    `fake_gpus`. `repeats` times each flow. Runs on the card unless the
    caller passes device="cpu".

    Returns {"cap_mknod", "codec_ms", "live" and
    "live_errors" (card only), "fake": {n: flow}, "fake_errors",
    "call_ms": {"live"?, "fake"}}; a flow holds the case, add_ms and
    remove_ms (each request's round trip, host clock), the UUIDs mounted and
    the refusal."""
    device = resolve_device(device)
    cfg = Config(auth_mode="token", auth_token=secrets.token_hex(16))
    report = {"cap_mknod": has_cap_mknod(),
              "codec_ms": _codec_ms(), "call_ms": {}}
    root = tempfile.mkdtemp(prefix="master-check-")
    try:
        if device.type == "cuda":
            cluster = FakeCluster(NvidiaDeviceBackend("/dev", identity=make_identity(identity)),
                                  cfg=cfg)
            target, dirs = _live_target(root, dev_dir, cgroup_dirs)
            expect = "round-trip" if report["cap_mknod"] else "refused"
            with _MasterStack(cluster, {cluster.node_name: target}, ns_pid, dirs) as stack:
                report["live"] = _master_flow(stack, target, 1, repeats, expect,
                                              on_mounted=on_mounted, live=True)
                report["live_errors"] = _master_errors(stack, target)
                report["call_ms"]["live"] = stack.call_ms(repeats)
        fake = FakeCluster.with_fake_gpus(os.path.join(root, "fake"), fake_gpus, cfg=cfg)
        fake_dir = os.path.join(root, "fake-tenant-dev")
        os.makedirs(fake_dir)
        with _MasterStack(fake, {fake.node_name: fake_dir}) as stack:
            report["fake"] = {n: _master_flow(stack, fake_dir, n, repeats, "round-trip")
                              for n in sorted({1, fake_gpus})}
            report["fake_errors"] = _master_errors(stack, fake_dir)
            report["call_ms"]["fake"] = stack.call_ms(repeats)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return report


# --- the master's slice and batch routes over several nodes ---

#: the fake fleet of slice_check: NODES hosts of GPUS fake GPUs each (the
#: H100 host of topology.py)
SLICE_FLEET = dict(NODES=4, GPUS=8)


def _slices_released(cluster, pods, free: dict) -> None:
    """No slave pod left for any of `pods`, and the free GPUs of each node
    as in `free`."""
    for pod in pods:
        slaves = cluster.kube.list_pods(cluster.cfg.pool_namespace,
                                        label_selector=f"tpumounter.io/owner-uid={pod.uid}")
        if slaves:
            raise RuntimeError(f"{pod.name}: slave pods {[Pod(s).name for s in slaves]} not "
                               f"released")
    got = {node: cluster.free_gpu_count(node) for node in free}
    if got != free:
        raise RuntimeError(f"free GPUs by node {got}, {free} before")


def _check_plan(plan: dict, pods, gpus: int) -> None:
    """The plan's workers in the request's order, each with its rank and the
    shared torch.distributed env."""
    hosts = len(pods)
    want_env = {"MASTER_ADDR": pods[0].pod_ip, "NNODES": str(hosts),
                "NPROC_PER_NODE": str(gpus), "WORLD_SIZE": str(hosts * gpus)}
    workers = plan["workers"]
    if [(w["pod"], w["node"], w["address"]) for w in workers] != [
            (p.name, p.node_name, p.pod_ip) for p in pods]:
        raise RuntimeError(f"the plan's workers {workers}, the pods {pods}")
    for rank, worker in enumerate(workers):
        env = {k: v for k, v in worker["env"].items() if k != "ACCELERATOR_TYPE"}
        if env != {"NODE_RANK": str(rank), **want_env}:
            raise RuntimeError(f"worker {rank}'s env {worker['env']}, expected {want_env}")


def _slice_flow(stack: _MasterStack, pods, gpus: int, repeats: int, expect: str,
                accel: str | None = None, on_mounted=None, live: bool = False) -> dict:
    """`repeats` times: POST /addslice of `gpus` a pod (entire mounts), then
    (when it mounted) POST /removeslice, each answer and its effect
    checked on every node; `expect` is "round-trip" or "refused" (500 naming
    CAP_MKNOD, rolled back). on_mounted(plan, uuids, dev_dir) runs once,
    while mounted, with the first pod's UUIDs and directory."""
    cluster = stack.cluster
    nodes = [p.node_name for p in pods]
    free = {node: cluster.free_gpu_count(node) for node in nodes}
    body = {"pods": [{"namespace": p.namespace, "pod": p.name} for p in pods],
            "gpusPerHost": gpus, **({"acceleratorType": accel} if accel else {})}
    out = {"case": expect, "hosts": len(pods), "gpus": gpus, "add_ms": [], "remove_ms": [],
           "plan": None, "uuids": None, "refusal": None}
    for i in range(repeats):
        status, text, ms = stack.http("POST", "/addslice", payload=body)
        out["add_ms"].append(ms)
        if expect == "refused":
            if status != 500 or "CAP_MKNOD" not in text:
                raise RuntimeError(f"/addslice without CAP_MKNOD: {status} {text!r}")
            _slices_released(cluster, pods, free)
            out["refusal"] = text.strip()
            continue
        if status != 200:
            raise RuntimeError(f"/addslice {body}: {status} {text!r}")
        plan = json.loads(text)
        _check_plan(plan, pods, gpus)
        uuids = {}
        for pod in pods:
            uuids[pod.name] = stack.held(pod.node_name, pod)
            if len(uuids[pod.name]) != gpus or cluster.free_gpu_count(pod.node_name) != \
                    free[pod.node_name] - gpus:
                raise RuntimeError(f"{pod.name} on {pod.node_name} holds {uuids[pod.name]}, "
                                   f"{cluster.free_gpu_count(pod.node_name)} free after the "
                                   f"slice's add")
            _check_nodes(cluster.node(pod.node_name).backend, uuids[pod.name],
                         stack.services[pod.node_name].mounter.dev_dir, live)
        if on_mounted is not None and i == 0:
            on_mounted(plan, uuids[pods[0].name], stack.services[nodes[0]].mounter.dev_dir)
        status, text, ms = stack.http("POST", "/removeslice", payload={"pods": body["pods"]})
        out["remove_ms"].append(ms)
        if (status, json.loads(text) if status == 200 else text) != (
                200, {"removed": {p.name: "Success" for p in pods}}):
            raise RuntimeError(f"/removeslice: {status} {text!r}")
        for pod in pods:
            dev_dir = stack.services[pod.node_name].mounter.dev_dir
            backend = cluster.node(pod.node_name).backend
            left = [u for u in uuids[pod.name]
                    if os.path.lexists(os.path.join(dev_dir, backend.device_by_uuid(u).basename))]
            if left:
                raise RuntimeError(f"{left} still in {dev_dir} after /removeslice")
        _slices_released(cluster, pods, free)
        out.update(plan=plan, uuids=uuids)
    return out


def _squatted_slice(stack: _MasterStack, pods, squat: str, repeats: int) -> dict:
    """A pod on node `squat` takes all its GPUs; then, `repeats` times,
    /addslice of 1 GPU a pod must answer 503 naming InsufficientGPU on that
    host, with every other host free again (rolled back). The squatter's GPUs
    are removed at the end."""
    cluster = stack.cluster
    squatter = cluster.add_target_pod("squatter", node=squat)
    status, text, _ = stack.http("POST", "/batch/addgpu", payload={"targets": [
        {"pod": squatter.name, "gpus": cluster.free_gpu_count(squat)}]})
    if status != 200 or json.loads(text)["summary"]["success"] != 1:
        raise RuntimeError(f"the squatter's batch add: {status} {text!r}")
    free = {p.node_name: cluster.free_gpu_count(p.node_name) for p in pods}
    rank = next(p.name for p in pods if p.node_name == squat)
    body = {"pods": [{"namespace": p.namespace, "pod": p.name} for p in pods], "gpusPerHost": 1}
    out = {"ms": [], "status": None, "body": None}
    for _ in range(repeats):
        status, text, ms = stack.http("POST", "/addslice", payload=body)
        out["ms"].append(ms)
        want = f"slice mount failed ({rank}: InsufficientGPU)\n"
        if (status, text) != (503, want):
            raise RuntimeError(f"/addslice with {squat} squatted: {status} {text!r}")
        _slices_released(cluster, pods, free)
        out.update(status=status, body=text.strip())
    _remove_all(stack, [(squatter, squat)])
    return out


def _remove_all(stack: _MasterStack, placed) -> None:
    """POST /removegpu of every GPU each (pod, node) holds."""
    for pod, node in placed:
        uuids = stack.held(node, pod)
        status, text, _ = stack.http("POST", _remove_path(pod), {"uuids": ",".join(uuids)})
        if status != 200:
            raise RuntimeError(f"remove of {pod.name}'s {uuids}: {status} {text!r}")


def _batch_flow(stack: _MasterStack, repeats: int) -> dict:
    """`repeats` times: POST /batch/addgpu of two targets a node (1 GPU and
    2 GPUs) and a pod that does not exist, last; each target's result in
    request order, the summary, and the books of every node checked, then
    every mount removed."""
    cluster = stack.cluster
    placed = [(cluster.add_target_pod(f"batch-{j}", node=node), node)
              for j, node in enumerate(cluster.node_names * 2)]
    gpus = [1 + j // len(cluster.node_names) for j in range(len(placed))]
    free = {node: cluster.free_gpu_count(node) for node in cluster.node_names}
    body = {"targets": [{"namespace": p.namespace, "pod": p.name, "gpus": n}
                        for (p, _), n in zip(placed, gpus)] + [{"pod": "ghost"}]}
    out = {"ms": [], "by_result": None, "targets": len(body["targets"])}
    for _ in range(repeats):
        status, text, ms = stack.http("POST", "/batch/addgpu", payload=body)
        out["ms"].append(ms)
        if status != 200:
            raise RuntimeError(f"/batch/addgpu: {status} {text!r}")
        answer = json.loads(text)
        results = answer["results"]
        got = [(r["pod"], r.get("node"), r["result"], len(r.get("uuids", ()))) for r in results]
        want = [(p.name, node, "Success", n) for (p, node), n in zip(placed, gpus)] + [
            ("ghost", None, "PodNotFound", 0)]
        if got != want or answer["summary"] != {
                "total": len(want), "success": len(placed),
                "byResult": {"Success": len(placed), "PodNotFound": 1}}:
            raise RuntimeError(f"/batch/addgpu: {answer}")
        for node in cluster.node_names:
            taken = sum(n for (_, at), n in zip(placed, gpus) if at == node)
            if cluster.free_gpu_count(node) != free[node] - taken:
                raise RuntimeError(f"{node}: {cluster.free_gpu_count(node)} free after the "
                                   f"batch, {free[node]} before, {taken} mounted")
        _remove_all(stack, placed)
        _slices_released(cluster, [p for p, _ in placed], free)
        out["by_result"] = answer["summary"]["byResult"]
    return out


def slice_check(device="cuda", *, dev_dir: str | None = None, ns_pid: int | None = None,
                cgroup_dirs=(), identity: str = "nvml", repeats: int = 3,
                on_mounted=None) -> dict:
    """The master's slice and batch routes over HTTP: ``MasterApp`` on
    ``build_http_server(port=0, host="127.0.0.1")`` in front of one worker
    gRPC server a node, each node's kubelet over gRPC. Without grpcio it
    raises ``ModuleNotFoundError`` naming grpcio.

    On the card (device="cuda"): a slice of 1 host x 1 GPU over the live
    ``NvidiaDeviceBackend`` (wired as ``mount_check`` wires it: `dev_dir`,
    `ns_pid`, `cgroup_dirs`, `identity`), whose target pod's IP is 127.0.0.1:
    POST /addslice with acceleratorType nvidia-h100-80gb, the plan and the
    node checked, on_mounted(plan, uuids, dev_dir) called once (the caller
    starts its tenant there, on the plan's env); POST /removeslice, the node
    gone and the slave pod released. Without CAP_MKNOD the add answers 500
    naming it and the rollback leaves all free. On both devices, a fake fleet
    of SLICE_FLEET["NODES"] hosts of SLICE_FLEET["GPUS"] GPUs: the slice of
    every GPU of every host added and removed; a slice of 1 a host with one
    host squatted, rolled back (503); a batch of two targets a node and a
    pod that does not exist. `repeats` times each. Runs on the card unless
    the caller passes device="cpu".

    Returns {"cap_mknod", "live" (card only) and "fleet" (``_slice_flow``'s
    reports: add_ms and remove_ms, host clock, each request's round trip;
    the last plan; the UUIDs; the refusal), "rollback" (ms, status, body),
    "batch" (ms, by_result, targets), "fanout_tasks" (the fan-out core's
    tasks by kind during the check)}."""
    device = resolve_device(device)
    cfg = Config(auth_mode="token", auth_token=secrets.token_hex(16))
    tasks_before = FANOUT_TASKS.snapshot()
    report = {"cap_mknod": has_cap_mknod()}
    root = tempfile.mkdtemp(prefix="slice-check-")
    try:
        if device.type == "cuda":
            cluster = FakeCluster(NvidiaDeviceBackend("/dev", identity=make_identity(identity)),
                                  cfg=cfg)
            target, dirs = _live_target(root, dev_dir, cgroup_dirs)
            with _MasterStack(cluster, {cluster.node_name: target}, ns_pid, dirs) as stack:
                pod = cluster.add_target_pod("tenant-slice", ip="127.0.0.1")
                report["live"] = _slice_flow(
                    stack, [pod], 1, repeats,
                    "round-trip" if report["cap_mknod"] else "refused",
                    accel="nvidia-h100-80gb", on_mounted=on_mounted, live=True)
        names = [f"host-{i}" for i in range(SLICE_FLEET["NODES"])]
        fleet = FakeCluster.with_fake_gpus(os.path.join(root, "fleet"),
                                           nodes={n: SLICE_FLEET["GPUS"] for n in names},
                                           cfg=cfg)
        dirs = {}
        for name in names:
            dirs[name] = os.path.join(root, f"tenant-dev-{name}")
            os.makedirs(dirs[name])
        with _MasterStack(fleet, dirs) as stack:
            pods = [fleet.add_target_pod(f"rank-{i}", node=n) for i, n in enumerate(names)]
            report["fleet"] = _slice_flow(stack, pods, SLICE_FLEET["GPUS"], repeats,
                                          "round-trip", accel="nvidia-h100-80gb")
            report["rollback"] = _squatted_slice(stack, pods, names[len(names) // 2], repeats)
            report["batch"] = _batch_flow(stack, repeats)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    report["fanout_tasks"] = {dict(k)["kind"]: v - tasks_before.get(k, 0.0)
                              for k, v in FANOUT_TASKS.snapshot().items()
                              if v != tasks_before.get(k, 0.0)}
    return report


# --- the trace, audit and flight-recorder core, and the failpoints ---

#: the spans of one traced add of 1 GPU, each by its parent's name ("" for
#: the root), and of its remove
ADD_TRACE = {"http.add": "", "k8s.get_pod": "http.add", "rpc.AddGPU": "http.add",
             "worker.AddGPU": "rpc.AddGPU", "mount.slave_pod_schedule": "worker.AddGPU",
             "mount.cgroup_grant": "worker.AddGPU", "mount.mknod": "worker.AddGPU",
             "mount.verify": "worker.AddGPU"}
REMOVE_TRACE = {"http.remove": "", "k8s.get_pod": "http.remove",
                "rpc.RemoveGPU": "http.remove", "worker.RemoveGPU": "rpc.RemoveGPU",
                "unmount.cgroup_revoke": "worker.RemoveGPU",
                "unmount.device_remove": "worker.RemoveGPU"}
#: the worker's spans under worker.AddGPU
ADD_WORKER_SPANS = ("mount.slave_pod_schedule", "mount.cgroup_grant", "mount.mknod",
                    "mount.verify")
#: obs_check's cost loops: fire() calls, spans, audit records
OBS_COST_ITERS = dict(FIRE=10**6, SPAN=10**4, AUDIT=10**4)


def _trace_spans(stack: _MasterStack, tid: str) -> list[dict]:
    status, text, _ = stack.http("GET", f"/trace/{tid}")
    if status != 200:
        raise RuntimeError(f"GET /trace/{tid}: {status} {text!r}")
    return json.loads(text)["spans"]


def _span_tree(spans: list[dict]) -> dict[str, str]:
    """name -> its parent's name ("" for a root, the parent's id when the
    parent is not in the trace)."""
    names = {s["span_id"]: s["name"] for s in spans}
    return {s["name"]: names.get(s["parent_id"], s["parent_id"]) for s in spans}


def _audit_outcomes(stack: _MasterStack, tid: str) -> dict[str, list[str]]:
    """operation -> the outcomes of its records under trace `tid`, over /audit."""
    status, text, _ = stack.http("GET", f"/audit?trace={tid}")
    if status != 200:
        raise RuntimeError(f"GET /audit?trace={tid}: {status} {text!r}")
    out: dict[str, list[str]] = {}
    for rec in json.loads(text)["records"]:
        out.setdefault(rec["operation"], []).append(rec["outcome"])
    return out


def _no_gpu_node(cluster, node: str, dev_dir: str, what: str) -> None:
    left = [d.basename for d in cluster.node(node).backend.list_devices()
            if os.path.lexists(os.path.join(dev_dir, d.basename))]
    if left:
        raise RuntimeError(f"{what}: {left} left in {dev_dir}")


def _events_for(cluster, pod) -> list[str]:
    return [m["reason"] for _, m in cluster.kube.events_posted
            if m["involvedObject"]["name"] == pod.name]


def _traced_round_trips(stack: _MasterStack, pod, dev_dir: str, repeats: int, live: bool) -> dict:
    """`repeats` times: GET /addgpu/.../gpu/1 and POST /removegpu of its UUID,
    each with its own trace id on the response; each trace's spans, parents
    and status, both requests' audit records (the edge's and the worker's,
    each with that trace id), the timeline under that id (the root span, both
    records and the pod's Event), no open span after, and the Events on the
    pod."""
    cluster = stack.cluster
    node = pod.node_name
    free = cluster.free_gpu_count(node)
    out = {"add_ms": [], "remove_ms": [], "span_ms": {}, "worker_share": [], "trace_ids": []}
    for _ in range(repeats):
        status, text, add_ms, add_tid = stack.traced("GET", _add_path(pod, 1))
        if (status, text) != (200, "Add GPU Success\n") or len(add_tid) != 32:
            raise RuntimeError(f"traced add: {status} {text!r}, trace {add_tid!r}")
        uuids = stack.held(node, pod)
        _check_nodes(cluster.node(node).backend, uuids, dev_dir, live)
        status, text, remove_ms, rm_tid = stack.traced("POST", _remove_path(pod),
                                                       {"uuids": ",".join(uuids)})
        if (status, text) != (200, "Remove 1 GPUs Success\n") or rm_tid in ("", add_tid):
            raise RuntimeError(f"traced remove: {status} {text!r}, trace {rm_tid!r}")
        _no_gpu_node(cluster, node, dev_dir, "the traced remove")
        _released(cluster, pod, free)
        for tid, want, ops in ((add_tid, ADD_TRACE, ("http.add", "worker.AddGPU", "GPUMounted:")),
                               (rm_tid, REMOVE_TRACE,
                                ("http.remove", "worker.RemoveGPU", "GPUUnmounted:"))):
            spans = _trace_spans(stack, tid)
            tree = _span_tree(spans)
            failed = [s["name"] for s in spans if s["status"] != "ok"]
            if tree != want or failed:
                raise RuntimeError(f"trace {tid}: {tree} (failed {failed}), expected {want}")
            outcomes = _audit_outcomes(stack, tid)
            if outcomes != {ops[0]: ["http 200"], ops[1]: ["Success"]}:
                raise RuntimeError(f"audit under trace {tid}: {outcomes}")
            status, text, _ = stack.http("GET", f"/timeline?trace={tid}")
            records = json.loads(text)["records"] if status == 200 else []
            kinds = sorted((r["kind"], r["summary"].split(" ")[0]) for r in records)
            if kinds != sorted([("span", ops[0]), ("audit", ops[0]), ("audit", ops[1]),
                                ("event", ops[2])]):
                raise RuntimeError(f"/timeline?trace={tid}: {status} {kinds}")
            if tid == add_tid:
                by_name = {s["name"]: s for s in spans}
                for s in spans:
                    out["span_ms"].setdefault(s["name"], []).append(s["duration_s"] * 1e3)
                out["worker_share"].append(
                    sum(by_name[n]["duration_s"] for n in ADD_WORKER_SPANS)
                    / by_name["worker.AddGPU"]["duration_s"])
        if trace.TRACER.open_spans():
            raise RuntimeError(f"open spans after the round trip: {trace.TRACER.open_spans()}")
        out["add_ms"].append(add_ms)
        out["remove_ms"].append(remove_ms)
        out["trace_ids"].append((add_tid, rm_tid))
    reasons = _events_for(cluster, pod)
    if reasons.count("GPUMounted") < repeats or reasons.count("GPUUnmounted") < repeats:
        raise RuntimeError(f"Events on {pod.name}: {reasons}")
    out["events"] = sorted(set(reasons))
    return out


def _devices_list(cgroup_dir: str) -> list | None:
    """The v1 rules `cgroup_dir` allows (its devices.list, one a line), or
    None where it has no readable one (a stand-in of the v1 files)."""
    try:
        with open(os.path.join(cgroup_dir, "devices.list")) as f:
            return [line.strip() for line in f if line.strip()]
    except OSError:
        return None


def _v1_revoked(cgroup_dir: str, held: list | None, before: list | None, rule: str) -> str:
    """What shows that a rolled-back grant of `rule` ("c <major>:<minor> ")
    was revoked on `cgroup_dir`; raises where something shows it was not.
    `held` and `before` are the cgroup's devices.list while an add held the
    GPU and after its remove. Where devices.list showed that grant, it must
    hold `before`'s rules after the rollback (in any order: the list is a
    set of rules, and a kernel may list them anew), without the rule. Where
    it did not
    (a host that allows "a *:* rwm" hides any one rule), the revoke is not
    verified. Without a devices.list (a stand-in of the v1 files), the
    stand-in's devices.deny holds the last rule written, which must be the
    GPU's. A real devices.deny is write-only."""
    after = _devices_list(cgroup_dir)
    if after is not None:
        if held is None or not any(line.startswith(rule) for line in held):
            return f"not verified: devices.list did not show the grant (it read {held})"
        if sorted(after) != sorted(before) or any(line.startswith(rule) for line in after):
            raise RuntimeError(f"{cgroup_dir}/devices.list after the rollback: {after}, before "
                               f"the add {before}; expected no {rule.strip()!r} and no change")
        return f"devices.list as before the add, without {rule.strip()!r}"
    try:
        with open(os.path.join(cgroup_dir, "devices.deny")) as f:
            denied = f.read().strip()
    except OSError:
        denied = ""
    if not denied:
        return "not verified: neither devices.list nor devices.deny reads back"
    if not denied.startswith(rule):
        raise RuntimeError(f"{cgroup_dir}/devices.deny after the rollback: {denied!r}, "
                           f"expected {rule.strip()!r}")
    return f"the stand-in's devices.deny holds {denied!r}"


def _fault_after_grant(stack: _MasterStack, pod, dev_dir: str, cgroup_dirs) -> dict:
    """worker.mount.after_grant=1*error: 500; the mount.rollback span undid
    the grant on every cgroup (no revoke failed, and ``_v1_revoked``'s
    verdict on each), no node is left, the slave pod is released, and both
    audit records under the trace id are failures."""
    cluster, node = stack.cluster, pod.node_name
    free = cluster.free_gpu_count(node)
    failures = MOUNT_ROLLBACK_FAILURES.total()
    # each cgroup's devices.list while a GPU is held, then after its remove
    status, text, _ = stack.http("GET", _add_path(pod, 1))
    if status != 200:
        raise RuntimeError(f"add before the fault: {status} {text!r}")
    held = [_devices_list(cg) for cg in cgroup_dirs]
    status, text, _ = stack.http("POST", _remove_path(pod),
                                 {"uuids": ",".join(stack.held(node, pod))})
    if status != 200:
        raise RuntimeError(f"remove before the fault: {status} {text!r}")
    before = [_devices_list(cg) for cg in cgroup_dirs]
    for cg, rules in zip(cgroup_dirs, before, strict=True):
        if rules is None:  # a stand-in: empty devices.deny, so that it shows the rollback's write
            with contextlib.suppress(OSError):
                open(os.path.join(cg, "devices.deny"), "w").close()
    with failpoints.armed({"worker.mount.after_grant": "1*error(injected after the grant)"}):
        status, text, ms, tid = stack.traced("GET", _add_path(pod, 1))
    if status != 500 or "injected after the grant" not in text:
        raise RuntimeError(f"add under worker.mount.after_grant: {status} {text!r}")
    spans = {s["name"]: s for s in _trace_spans(stack, tid)}
    rollback = spans.get("mount.rollback")
    if rollback is None or rollback["status"] != "ok" or \
            rollback["attrs"]["cgroups"] != len(cgroup_dirs) or \
            spans["worker.AddGPU"]["status"] != "error":
        raise RuntimeError(f"trace {tid} of the failed add: {sorted(spans)}, rollback {rollback}")
    if MOUNT_ROLLBACK_FAILURES.total() != failures:
        raise RuntimeError("a grant's undo failed in the rollback")
    gpu = cluster.node(node).backend.list_devices()[0]
    revoke = [_v1_revoked(cg, h, b, f"c {gpu.major}:{gpu.minor} ")
              for cg, h, b in zip(cgroup_dirs, held, before, strict=True)]
    _no_gpu_node(cluster, node, dev_dir, "the rolled-back add")
    if cluster.free_gpu_count(node) != free:
        raise RuntimeError(f"{cluster.free_gpu_count(node)} free after the rollback, {free} before")
    outcomes = _audit_outcomes(stack, tid)
    if outcomes.get("http.add") != ["http 500"] or \
            not outcomes.get("worker.AddGPU", [""])[0].startswith("error: ServiceError"):
        raise RuntimeError(f"audit of the failed add: {outcomes}")
    if "GPUMountFailed" not in _events_for(cluster, pod):
        raise RuntimeError(f"no GPUMountFailed Event on {pod.name}: {_events_for(cluster, pod)}")
    return {"status": status, "ms": ms, "rollback_ms": rollback["duration_s"] * 1e3,
            "revoke": revoke, "outcomes": outcomes}


def _fault_dropped_call(stack: _MasterStack, pod, dev_dir: str, live: bool) -> dict:
    """rpc.client.call=1*unavailable: 200 after one retry; the worker ran
    once, its one record under the call's one idempotency key; then the
    remove."""
    cluster, node = stack.cluster, pod.node_name
    retries = RPC_RETRIES.get(method="AddGPU")
    with failpoints.armed({"rpc.client.call": "1*unavailable(injected drop)"}):
        status, text, ms, tid = stack.traced("GET", _add_path(pod, 1))
    if (status, text) != (200, "Add GPU Success\n"):
        raise RuntimeError(f"add under rpc.client.call: {status} {text!r}")
    names = [s["name"] for s in _trace_spans(stack, tid)]
    status_a, body, _ = stack.http("GET", f"/audit?trace={tid}&op=worker.")
    keys = [r["idempotency_key"] for r in json.loads(body)["records"]]
    if RPC_RETRIES.get(method="AddGPU") - retries != 1 or names.count("worker.AddGPU") != 1 \
            or names.count("rpc.AddGPU") != 1 or len(keys) != 1 or not keys[0].startswith("add-"):
        raise RuntimeError(f"the dropped call: retries "
                           f"{RPC_RETRIES.get(method='AddGPU') - retries}, spans {names}, "
                           f"worker records' keys {keys}")
    uuids = stack.held(node, pod)
    _check_nodes(cluster.node(node).backend, uuids, dev_dir, live)
    status, text, _ = stack.http("POST", _remove_path(pod), {"uuids": ",".join(uuids)})
    if status != 200:
        raise RuntimeError(f"remove after the retried add: {status} {text!r}")
    return {"status": 200, "ms": ms, "retries": 1, "idempotency_key": keys[0]}


def _fault_two_gpu_mknod(stack: _MasterStack, pod, dev_dir: str) -> dict:
    """worker.mount.mknod=1*pass->1*error on an add of 2: 500, neither GPU
    mounted nor booked, the mknod span failed and the rollback ran."""
    cluster, node = stack.cluster, pod.node_name
    free = cluster.free_gpu_count(node)
    with failpoints.armed({"worker.mount.mknod": "1*pass->1*error(injected at the 2nd GPU)"}):
        status, text, ms, tid = stack.traced("GET", _add_path(pod, 2))
    if status != 500 or "injected at the 2nd GPU" not in text:
        raise RuntimeError(f"add of 2 under worker.mount.mknod: {status} {text!r}")
    spans = {s["name"]: s["status"] for s in _trace_spans(stack, tid)}
    if spans.get("mount.mknod") != "error" or spans.get("mount.rollback") != "ok":
        raise RuntimeError(f"trace {tid} of the failed add of 2: {spans}")
    _no_gpu_node(cluster, node, dev_dir, "the add of 2 that failed at its 2nd mknod")
    if cluster.free_gpu_count(node) != free or stack.held(node, pod):
        raise RuntimeError(f"the add of 2 left {stack.held(node, pod)} booked, "
                           f"{cluster.free_gpu_count(node)} free of {free}")
    return {"status": status, "ms": ms}


def _fault_slice_admission(stack: _MasterStack, pod, dev_dir: str) -> dict:
    """master.slice.mount=1*error on a slice of 1: 500 and nothing changed;
    the edge's audit record holds the failpoint's error (an exception that
    is no HTTP answer, as in the reference)."""
    cluster, node = stack.cluster, pod.node_name
    free = cluster.free_gpu_count(node)
    body = {"pods": [{"namespace": pod.namespace, "pod": pod.name}], "gpusPerHost": 1}
    with failpoints.armed({"master.slice.mount": "1*error(injected at the slice's admission)"}):
        status, text, ms, tid = stack.traced("POST", "/addslice", payload=body)
    if status != 500 or "injected at the slice's admission" not in text:
        raise RuntimeError(f"/addslice under master.slice.mount: {status} {text!r}")
    _no_gpu_node(cluster, node, dev_dir, "the refused slice")
    if cluster.free_gpu_count(node) != free or stack.held(node, pod):
        raise RuntimeError("the refused slice changed the books")
    outcomes = _audit_outcomes(stack, tid)
    if list(outcomes) != ["http.addslice"] or \
            not outcomes["http.addslice"][0].startswith("error: FailpointError"):
        raise RuntimeError(f"audit of the refused slice: {outcomes}")
    return {"status": status, "ms": ms}


def _obs_flows(stack: _MasterStack, dev_dir: str, cgroup_dirs, repeats: int, live: bool) -> dict:
    """(a) the traced round trips, (b) the live faults but the add of 2,
    each case ending with the GPU addable again (a last traced round trip)."""
    pod = stack.cluster.add_target_pod("tenant-obs")
    out = {"round_trip": _traced_round_trips(stack, pod, dev_dir, repeats, live)}
    out["after_grant"] = _fault_after_grant(stack, pod, dev_dir, cgroup_dirs)
    out["dropped_call"] = _fault_dropped_call(stack, pod, dev_dir, live)
    out["slice_admission"] = _fault_slice_admission(stack, pod, dev_dir)
    out["again"] = _traced_round_trips(stack, pod, dev_dir, 1, live)
    if failpoints.active():
        raise RuntimeError(f"failpoints left armed: {failpoints.active()}")
    return out


def _obs_costs() -> dict:
    """What the instrumentation costs on this host: a fire() with nothing
    armed (ns, mean of OBS_COST_ITERS["FIRE"]), one empty root span into a
    ring and one audited record (us, means), each on a private store."""
    if failpoints.active():
        raise RuntimeError(f"the cost of an unarmed fire() with {failpoints.active()} armed")
    n = OBS_COST_ITERS["FIRE"]
    fire = failpoints.fire
    t0 = time.perf_counter()
    for _ in range(n):
        fire("worker.mount.mknod")
    fire_ns = (time.perf_counter() - t0) / n * 1e9
    n = OBS_COST_ITERS["SPAN"]
    tracer = trace.Tracer(ring_capacity=n)
    t0 = time.perf_counter()
    for _ in range(n):
        with trace.span("cost.empty", tracer=tracer):
            pass
    span_us = (time.perf_counter() - t0) / n * 1e6
    n = OBS_COST_ITERS["AUDIT"]
    log = audit.AuditLog(capacity=n)
    t0 = time.perf_counter()
    for _ in range(n):
        with audit.audited("cost.op", log=log):
            pass
    audit_us = (time.perf_counter() - t0) / n * 1e6
    return {"fire_ns": fire_ns, "span_us": span_us, "audit_us": audit_us}


def obs_check(device="cuda", *, dev_dir: str | None = None, ns_pid: int | None = None,
              cgroup_dirs=(), identity: str = "nvml", fake_gpus: int = 8,
              repeats: int = 3) -> dict:
    """The trace, audit and flight-recorder core and the failpoints, through
    the master over gRPC (``_MasterStack``, as ``master_check`` wires it).
    Without grpcio it raises ``ModuleNotFoundError`` naming grpcio.

    (a) `repeats` traced round trips (GET /addgpu/.../gpu/1, POST /removegpu
    of its UUID): a trace id on each response; /trace/<id> holds ADD_TRACE
    (REMOVE_TRACE), each span ok and parented as listed; no span open after;
    /audit under the id holds the edge's record ("http 200") and the worker's
    ("Success"); /timeline under the id the root span and both records; the
    pod's Events GPUMounted and GPUUnmounted. (b) worker.mount.after_grant
    (500, rolled back: ``_fault_after_grant``), rpc.client.call (200 after
    one retry: ``_fault_dropped_call``), master.slice.mount on a slice of 1
    (500, nothing changed), then a round trip again; and on the fake host of
    `fake_gpus`, an add of 2 under worker.mount.mknod=1*pass->1*error (500,
    neither mounted). (c) ``_obs_costs``.

    On the card (device="cuda", with CAP_MKNOD) (a) and (b) run on the live
    ``NvidiaDeviceBackend`` (`dev_dir`, `ns_pid`, `cgroup_dirs`, `identity`
    as in ``mount_check``), the add of 2 on the fake host; on the CPU, or
    without CAP_MKNOD, all on the fake host. Runs on the card unless the
    caller passes device="cpu".

    Returns {"cap_mknod", "live" (or None), "fake", "two_gpu_mknod",
    "costs"}; "live" and "fake" are ``_obs_flows``'s reports: add_ms and
    remove_ms (host clock, each round trip), span_ms (each span's ms, each
    round trip), worker_share, trace_ids, and each fault's status and ms."""
    device = resolve_device(device)
    cfg = Config(auth_mode="token", auth_token=secrets.token_hex(16))
    report = {"cap_mknod": has_cap_mknod(), "live": None, "fake": None}
    root = tempfile.mkdtemp(prefix="obs-check-")
    try:
        if device.type == "cuda":
            cluster = FakeCluster(NvidiaDeviceBackend("/dev", identity=make_identity(identity)),
                                  cfg=cfg)
            target, dirs = _live_target(root, dev_dir, cgroup_dirs)
            with _MasterStack(cluster, {cluster.node_name: target}, ns_pid, dirs) as stack:
                report["live"] = _obs_flows(stack, target, dirs, repeats, live=True)
        fake = FakeCluster.with_fake_gpus(os.path.join(root, "fake"), fake_gpus, cfg=cfg)
        fake_dir = os.path.join(root, "fake-tenant-dev")
        os.makedirs(fake_dir)
        with _MasterStack(fake, {fake.node_name: fake_dir}) as stack:
            if report["live"] is None:
                report["fake"] = _obs_flows(stack, fake_dir, [], repeats, live=False)
            pod = fake.add_target_pod("tenant-obs-2")
            report["two_gpu_mknod"] = _fault_two_gpu_mknod(stack, pod, fake_dir)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    report["costs"] = _obs_costs()
    return report


# --- the worker's durability: the ledger, its replay, the reaper, the drain, the fence ---

#: durability_check's fsync loop: appends timed in the ledger's directory
FSYNC_ITERS = 20


def _appends() -> float:
    return LEDGER_APPENDS.total()


def _fsync_us(directory: str, n: int = FSYNC_ITERS) -> list[float]:
    """One ledger line's fsync in `directory`, `n` times (us, host clock):
    what an append costs beyond its write(2)."""
    path = os.path.join(directory, "fsync-probe.jsonl")
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o600)
    out = []
    try:
        for i in range(n):
            os.write(fd, json.dumps({"kind": "probe", "i": i}).encode() + b"\n")
            t0 = time.perf_counter()
            os.fsync(fd)
            out.append((time.perf_counter() - t0) * 1e6)
    finally:
        os.close(fd)
        os.unlink(path)
    return out


def _ledger_of(service, ledger) -> None:
    """Attach `ledger` (or None) to the service and its mounter."""
    service.ledger = service.mounter.ledger = ledger


def _ledger_cost(stack: _MasterStack, pod, dev_dir: str, repeats: int, live: bool) -> dict:
    """(a) `repeats` HTTP adds and removes of 1 GPU with the ledger and as
    many without it, in turns (with, without, ...): each request's ms, the
    ledger's appends per add and per remove, and one append's fsync (us) in
    the ledger's directory."""
    cluster, node = stack.cluster, pod.node_name
    service = stack.services[node]
    ledger = service.ledger
    free = cluster.free_gpu_count(node)
    out = {"with": {"add_ms": [], "remove_ms": []}, "without": {"add_ms": [], "remove_ms": []},
           "appends_add": [], "appends_remove": []}
    try:
        for _ in range(repeats):
            for case in ("with", "without"):
                _ledger_of(service, ledger if case == "with" else None)
                before = _appends()
                status, text, add_ms = stack.http("GET", _add_path(pod, 1))
                if (status, text) != (200, "Add GPU Success\n"):
                    raise RuntimeError(f"add {case} the ledger: {status} {text!r}")
                added = _appends()
                uuids = stack.held(node, pod)
                _check_nodes(cluster.node(node).backend, uuids, dev_dir, live)
                status, text, rm_ms = stack.http("POST", _remove_path(pod),
                                                 {"uuids": ",".join(uuids)})
                if status != 200:
                    raise RuntimeError(f"remove {case} the ledger: {status} {text!r}")
                _no_gpu_node(cluster, node, dev_dir, f"the remove {case} the ledger")
                _released(cluster, pod, free)
                out[case]["add_ms"].append(add_ms)
                out[case]["remove_ms"].append(rm_ms)
                if case == "with":
                    out["appends_add"].append(added - before)
                    out["appends_remove"].append(_appends() - added)
    finally:
        _ledger_of(service, ledger)
    if set(out["appends_add"]) != {2} or set(out["appends_remove"]) != {2}:
        raise RuntimeError(f"ledger appends: {out['appends_add']} an add, "
                           f"{out['appends_remove']} a remove; 2 each expected")
    out["fsync_us"] = _fsync_us(ledger.directory)
    if ledger.open_transactions():
        raise RuntimeError(f"open txns after the round trips: {ledger.open_transactions()}")
    return out


def _books_mounts_ledger(stack: _MasterStack, pod, dev_dir: str) -> list[str]:
    """The pod's GPUs, checked equal in the books, in `dev_dir` and in the
    node's ledger (with no open txn); returns them."""
    node = pod.node_name
    ledger = stack.services[node].ledger
    books = sorted(stack.held(node, pod))
    mounts = sorted(d.uuid for d in stack.cluster.node(node).backend.list_devices()
                    if os.path.lexists(os.path.join(dev_dir, d.basename)))
    held = sorted(ledger.net_holdings().get((pod.namespace, pod.name), set()))
    if not (books == mounts == held) or ledger.open_transactions():
        raise RuntimeError(f"books {books}, mounts {mounts}, ledger {held}, open txns "
                           f"{ledger.open_transactions()}")
    return books


def _crash_replayed_forward(stack: _MasterStack, pod, dev_dir: str, live: bool,
                            on_replayed=None) -> dict:
    """(b) worker.mount.after_grant=1*crash on an HTTP add (500, one txn
    open), the worker restarted over its ledger and replayed: one open txn,
    replayed-completed, the GPU's node in `dev_dir`, books == mounts ==
    ledger; on_replayed(uuids, dev_dir); then the remove."""
    cluster, node = stack.cluster, pod.node_name
    free = cluster.free_gpu_count(node)
    with failpoints.armed({"worker.mount.after_grant": "1*crash(a worker death after the grant)"}):
        crash_status, text, crash_ms = stack.http("GET", _add_path(pod, 1))
    open_txns = len(stack.services[node].ledger.open_transactions())
    if crash_status != 500 or open_txns != 1:
        raise RuntimeError(f"the crashed add: {crash_status} {text!r}, {open_txns} open txn(s)")
    summary, replay_ms = stack.restart(node)
    if (summary["open"], len(summary["completed"]), len(summary["rolled_back"])) != (1, 1, 0):
        raise RuntimeError(f"the replay after the crash: {summary}")
    uuids = _books_mounts_ledger(stack, pod, dev_dir)
    if len(uuids) != 1:
        raise RuntimeError(f"{uuids} held after the replayed add of 1")
    _check_nodes(cluster.node(node).backend, uuids, dev_dir, live)
    child = on_replayed(uuids, dev_dir) if on_replayed is not None else None
    status, text, _ = stack.http("POST", _remove_path(pod), {"uuids": ",".join(uuids)})
    if status != 200:
        raise RuntimeError(f"remove of the replayed GPU: {status} {text!r}")
    _released(cluster, pod, free)
    return {"crash_status": crash_status, "crash_ms": crash_ms, "summary": summary,
            "replay_ms": replay_ms, "uuids": uuids, "child": child}


class _StampedClient:
    """A worker client that stamps one epoch on every mutation: a master
    replica whose view of the node's owner is old."""

    def __init__(self, client, epoch: int):
        self.client, self.epoch = client, epoch

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.client.close()
        return False

    def add_gpu(self, *args, **kwargs):
        return self.client.add_gpu(*args, epoch=self.epoch, **kwargs)

    def remove_gpu(self, *args, **kwargs):
        return self.client.remove_gpu(*args, epoch=self.epoch, **kwargs)


def _fenced(stack: _MasterStack, pod, dev_dir: str, live: bool) -> dict:
    """(e) over gRPC: an add with epoch 5 mounts; a remove with epoch 3
    raises FencedError, moves tpumounter_fenced_writes_total by 1 and
    changes nothing; the master whose client stamps epoch 3 answers 503
    with Retry-After 1; after a restart the ledger reads epoch 5 back; the
    remove with epoch 5 goes through."""
    from gpumounter_tpu_torch.rpc.resilience import FencedError
    cluster, node = stack.cluster, pod.node_name
    free = cluster.free_gpu_count(node)
    with stack.client(node) as client:
        t0 = time.perf_counter()
        added = client.add_gpu(pod.name, pod.namespace, 1, epoch=5)
        add_ms = (time.perf_counter() - t0) * 1e3
        if added.add_gpu_result != AddGPUResult.Success:
            raise RuntimeError(f"add with epoch 5: {added}")
        fenced0 = FENCED_WRITES.total()
        t0 = time.perf_counter()
        try:
            client.remove_gpu(pod.name, pod.namespace, list(added.uuids), epoch=3)
        except FencedError as exc:
            fenced_ms, refusal = (time.perf_counter() - t0) * 1e3, str(exc)
        else:
            raise RuntimeError("a remove with the stale epoch 3 went through")
    if FENCED_WRITES.total() - fenced0 != 1 or stack.held(node, pod) != list(added.uuids):
        raise RuntimeError(f"the fenced remove: {FENCED_WRITES.total() - fenced0} fenced, "
                           f"{stack.held(node, pod)} held")
    stale = MasterApp(cluster.kube, cfg=stack.cfg, worker_client_factory=lambda address:
                      _StampedClient(stack.app._client_factory(address), 3))
    try:
        status, _, text, headers = stale.handle(
            "POST", _remove_path(pod), urllib.parse.urlencode({"uuids": added.uuids[0]}).encode(),
            {"Authorization": f"Bearer {stack.token}"})
    finally:
        stale.close()
    if (status, headers.get("Retry-After")) != (503, "1") or \
            stack.held(node, pod) != list(added.uuids):
        raise RuntimeError(f"the stale master's remove: {status} {headers} {text!r}")
    stack.restart(node)
    epoch = stack.services[node].ledger.epoch()
    if epoch != 5:
        raise RuntimeError(f"the restarted worker's ledger reads epoch {epoch}, not 5")
    with stack.client(node) as client:
        removed = client.remove_gpu(pod.name, pod.namespace, list(added.uuids), epoch=5)
    if removed.remove_gpu_result != RemoveGPUResult.Success:
        raise RuntimeError(f"remove with epoch 5 after the restart: {removed}")
    _no_gpu_node(cluster, node, dev_dir, "the remove with epoch 5")
    _released(cluster, pod, free)
    return {"add_ms": add_ms, "fenced_ms": fenced_ms, "refusal": refusal,
            "master": (status, text.strip()), "epoch_after_restart": epoch}


def _drain_during_add(stack: _MasterStack, pod, dev_dir: str, live: bool) -> dict:
    """(d) an HTTP add, and drain() called from another thread once the add
    is inside the namespace helper (its mount.mknod span open): the add
    finishes (200), drain returns True, a second add over gRPC gets
    UNAVAILABLE "worker draining", and a reopened ledger reads a clean
    shutdown with no open txn. Then a new worker removes the GPU."""
    from gpumounter_tpu_torch.rpc.resilience import WorkerUnavailableError
    cluster, node = stack.cluster, pod.node_name
    service = stack.services[node]
    free = cluster.free_gpu_count(node)
    answer: dict = {}

    def add():
        answer["http"] = stack.http("GET", _add_path(pod, 1))

    drained: dict = {}

    def drain():
        t0 = time.perf_counter()
        drained["clean"] = service.drain(timeout_s=20.0)
        drained["ms"] = (time.perf_counter() - t0) * 1e3

    # a fake node's mknod is in process and takes microseconds: there the
    # site holds the add inside the span; the live helper takes ~80 ms
    hold = {} if live else {"worker.mount.mknod": "1*delay(0.2)"}
    with failpoints.armed(hold):
        adder = threading.Thread(target=add, name="drained-add")
        adder.start()
        deadline = time.monotonic() + 60
        while "mount.mknod" not in trace.TRACER.open_spans():
            if time.monotonic() > deadline or not adder.is_alive():
                adder.join(60)
                raise RuntimeError(f"the add never reached mount.mknod: {answer}")
            time.sleep(0.0005)
        drainer = threading.Thread(target=drain, name="drain")
        drainer.start()
        drainer.join(60)
        adder.join(60)
    if adder.is_alive() or drainer.is_alive():
        raise RuntimeError("the add or the drain did not end")
    status, text, add_ms = answer["http"]
    if (status, text) != (200, "Add GPU Success\n") or not drained.get("clean"):
        raise RuntimeError(f"the add during the drain: {status} {text!r}; drain {drained}")
    with stack.client(node) as client:
        try:
            client.add_gpu(pod.name, pod.namespace, 1)
        except WorkerUnavailableError as exc:
            refused = str(exc)
        else:
            raise RuntimeError("an add after the drain went through")
    if "worker draining" not in refused:
        raise RuntimeError(f"the add after the drain: {refused}")
    reopened = MountLedger(service.ledger.directory)
    clean, open_txns = reopened.was_clean_shutdown(), reopened.open_transactions()
    reopened.abandon()
    if not clean or open_txns:
        raise RuntimeError(f"the drained ledger: clean {clean}, open txns {open_txns}")
    uuids = stack.held(node, pod)
    _check_nodes(cluster.node(node).backend, uuids, dev_dir, live)
    summary, _ = stack.restart(node)
    if summary["open"]:
        raise RuntimeError(f"the replay after a clean drain: {summary}")
    status, text, _ = stack.http("POST", _remove_path(pod), {"uuids": ",".join(uuids)})
    if status != 200:
        raise RuntimeError(f"remove after the drain: {status} {text!r}")
    _released(cluster, pod, free)
    return {"add_ms": add_ms, "drain_ms": drained["ms"], "refused": refused}


def _crash_rolled_back(stack: _MasterStack, pod, dev_dir: str) -> dict:
    """(c) worker.mount.before_grant=1*crash on an add of 2 (500, one txn
    open), the slave pods deleted while the worker is down, the restart and
    the replay: replayed-rolled-back, no node, no booking, no open txn."""
    cluster, node = stack.cluster, pod.node_name
    free = cluster.free_gpu_count(node)
    with failpoints.armed({"worker.mount.before_grant": "1*crash(a worker death before the grant)"}):
        status, text, crash_ms = stack.http("GET", _add_path(pod, 2))
    if status != 500 or len(stack.services[node].ledger.open_transactions()) != 1:
        raise RuntimeError(f"the crashed add of 2: {status} {text!r}")
    slaves = [Pod(s).name for s in cluster.kube.list_pods(
        cluster.cfg.pool_namespace, label_selector=f"tpumounter.io/owner-uid={pod.uid}")]
    for name in slaves:
        cluster.kube.delete_pod(cluster.cfg.pool_namespace, name)
    summary, replay_ms = stack.restart(node)
    if (summary["open"], len(summary["rolled_back"]), len(summary["completed"])) != (1, 1, 0):
        raise RuntimeError(f"the replay with the bookings gone: {summary}")
    _no_gpu_node(cluster, node, dev_dir, "the rolled-back replay")
    _released(cluster, pod, free)
    if _books_mounts_ledger(stack, pod, dev_dir):
        raise RuntimeError("the rolled-back replay left holdings")
    return {"slaves_deleted": len(slaves), "crash_ms": crash_ms, "summary": summary,
            "replay_ms": replay_ms}


def _deferred_and_reaped(stack: _MasterStack, dev_dir: str) -> dict:
    """(f) a remove while the API refuses deletes (k8s.delete_pod.status=
    return(503)): 200, the release deferred (the series moves, one entry
    pending, the GPU still booked); healed, retry_pending_releases() empties
    the queue and frees it. Then an owner pod deleted with a GPU held: one
    reap_once() deletes its slave pod and frees the GPU."""
    cluster = stack.cluster
    node = cluster.node_name
    service = stack.services[node]
    free = cluster.free_gpu_count(node)
    pod = cluster.add_target_pod("tenant-deferred")
    status, text, _ = stack.http("GET", _add_path(pod, 1))
    if status != 200:
        raise RuntimeError(f"add before the refused deletes: {status} {text!r}")
    deferred0 = SLAVE_RELEASE_DEFERRED.total()
    with failpoints.armed({"k8s.delete_pod.status": "return(503)"}):
        status, text, remove_ms = stack.http("POST", _remove_path(pod),
                                             {"uuids": ",".join(stack.held(node, pod))})
    pending = service.ledger.pending_releases()
    deferred = SLAVE_RELEASE_DEFERRED.total() - deferred0
    if status != 200 or len(pending) != 1 or deferred != 1 or \
            cluster.free_gpu_count(node) != free - 1:
        raise RuntimeError(f"the remove while deletes fail: {status} {text!r}, pending "
                           f"{pending}, deferred {deferred}, {cluster.free_gpu_count(node)} free")
    t0 = time.perf_counter()
    retried = service.retry_pending_releases()
    retry_ms = (time.perf_counter() - t0) * 1e3
    if retried != {"completed": 1, "pending": 0} or service.ledger.pending_releases():
        raise RuntimeError(f"the healed retry: {retried}")
    _released(cluster, pod, free)
    owner = cluster.add_target_pod("tenant-reaped")
    status, text, _ = stack.http("GET", _add_path(owner, 1))
    if status != 200:
        raise RuntimeError(f"add before the owner's deletion: {status} {text!r}")
    cluster.kube.delete_pod(owner.namespace, owner.name)
    reaper = SlaveReaper(cluster.kube, cfg=cluster.cfg,
                         device_controller=service.mounter.controller)
    t0 = time.perf_counter()
    reaped = reaper.reap_once()
    reap_ms = (time.perf_counter() - t0) * 1e3
    if len(reaped) != 1 or cluster.free_gpu_count(node) != free:
        raise RuntimeError(f"the reap: {reaped}, {cluster.free_gpu_count(node)} free of {free}")
    return {"remove_ms": remove_ms, "deferred": deferred, "retry_ms": retry_ms,
            "reaped": reaped, "reap_ms": reap_ms}


def _durability_flows(stack: _MasterStack, dev_dir: str, repeats: int, live: bool,
                      on_replayed=None) -> dict:
    """(a), (b), (e) and (d) on the stack's one node, in that order (the
    drain last: it closes the worker)."""
    pod = stack.cluster.add_target_pod("tenant-ledger")
    return {"cost": _ledger_cost(stack, pod, dev_dir, repeats, live),
            "forward": _crash_replayed_forward(stack, pod, dev_dir, live, on_replayed),
            "fence": _fenced(stack, pod, dev_dir, live),
            "drain": _drain_during_add(stack, pod, dev_dir, live)}


def durability_check(device="cuda", *, dev_dir: str | None = None, ns_pid: int | None = None,
                     cgroup_dirs=(), identity: str = "nvml", fake_gpus: int = 8,
                     repeats: int = 3, ledger_root: str | None = None,
                     on_replayed=None) -> dict:
    """The worker's durability through the master over gRPC
    (``_MasterStack``, as ``master_check`` wires it, each worker with a
    ledger in a new directory under `ledger_root`, by default a temporary
    one). Without grpcio it raises ``ModuleNotFoundError`` naming grpcio.

    (a) ``_ledger_cost``: `repeats` HTTP round trips of 1 GPU with the
    ledger and as many without, in turns, the appends an add and a remove
    (2 each), and one append's fsync. (b) ``_crash_replayed_forward``: a
    death after the grant, the restart and the replay, forward;
    on_replayed(uuids, dev_dir) runs while the replayed GPU is mounted. (e)
    ``_fenced``: epochs 5 and 3 over gRPC, the stale master's 503, epoch 5
    after a restart. (d) ``_drain_during_add``. And on the fake host of
    `fake_gpus`: (c) ``_crash_rolled_back``, a death before the grant whose
    slave pods are deleted before the restart; (f) ``_deferred_and_reaped``.

    On the card (device="cuda") (a), (b), (e) and (d) run on the live
    ``NvidiaDeviceBackend`` (`dev_dir`, `ns_pid`, `cgroup_dirs`, `identity`
    as in ``mount_check``), and without CAP_MKNOD it raises: (b)'s replayed
    GPU must be the card's. On the CPU they run on the fake host. Runs on
    the card unless the caller passes device="cpu".

    Returns {"cap_mknod", "live" (the card's flows of (a), (b), (e), (d), or
    None), "fake" (theirs on the fake host, or None), "rolled_back",
    "deferred"}; ms on the host clock."""
    device = resolve_device(device)
    report = {"cap_mknod": has_cap_mknod(), "live": None, "fake": None}
    if device.type == "cuda" and not report["cap_mknod"]:
        raise RuntimeError("durability_check on the card needs CAP_MKNOD: the crashed add "
                           "must be replayed onto the card's own GPU")
    root = tempfile.mkdtemp(prefix="durability-check-")
    ledgers = tempfile.mkdtemp(prefix="ledgers-", dir=ledger_root)
    try:
        def cfg(name: str) -> Config:
            return Config(auth_mode="token", auth_token=secrets.token_hex(16),
                          ledger_dir=os.path.join(ledgers, name))

        if device.type == "cuda" and report["cap_mknod"]:
            cluster = FakeCluster(NvidiaDeviceBackend("/dev", identity=make_identity(identity)),
                                  cfg=cfg("live"))
            target, dirs = _live_target(root, dev_dir, cgroup_dirs)
            with _MasterStack(cluster, {cluster.node_name: target}, ns_pid, dirs) as stack:
                report["live"] = _durability_flows(stack, target, repeats, True, on_replayed)
        fake = FakeCluster.with_fake_gpus(os.path.join(root, "fake"), fake_gpus, cfg=cfg("fake"))
        fake_dir = os.path.join(root, "fake-tenant-dev")
        os.makedirs(fake_dir)
        with _MasterStack(fake, {fake.node_name: fake_dir}) as stack:
            if report["live"] is None:
                report["fake"] = _durability_flows(stack, fake_dir, repeats, False)
            pod = fake.add_target_pod("tenant-rolled-back")
            report["rolled_back"] = _crash_rolled_back(stack, pod, fake_dir)
            report["deferred"] = _deferred_and_reaped(stack, fake_dir)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(ledgers, ignore_errors=True)
    if failpoints.active():
        raise RuntimeError(f"failpoints left armed: {failpoints.active()}")
    return report


# --- the master's store through an API outage: ApiHealth, the cache, the queue ---

#: degraded_check's ApiHealth: degraded after 2 outage-shaped failures in a
#: row, down after a streak of 0.5 s, healthy after 2 successes in a row; no
#: write probe (the check drives the plane itself)
DEGRADED_HEALTH = dict(api_health_degraded_failures=2, api_health_down_after_s=0.5,
                       api_health_recovery_successes=2, api_health_probe_interval_s=0.0)
#: the annotations the write partition's stamps defer, and the CAS one
DEGRADED_STAMPS = ("tpumounter.io/migration-phase", "tpumounter.io/migration-ack",
                   "tpumounter.io/migration-lock")
DEGRADED_CAS = "tpumounter.io/chip-replaced"


def _median_us(fn, iters: int) -> list[float]:
    """fn() `iters` times after one warm call: each call's us, host clock."""
    fn()
    out = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e6)
    return out


def _slave_pods(cluster, pod) -> list[str]:
    return sorted(Pod(p).name for p in cluster.kube.list_pods(
        cluster.cfg.pool_namespace, label_selector=f"tpumounter.io/owner-uid={pod.uid}"))


def _queued_on_disk(directory: str) -> int:
    """The write records of the queue's file that no done record closes."""
    open_seqs: set[int] = set()
    with open(os.path.join(directory, QUEUE_FILE), encoding="utf-8") as f:
        for line in f:
            rec = json.loads(line)
            if rec["kind"] == "write":
                open_seqs.add(rec["seq"])
            else:
                open_seqs.discard(rec["seq"])
    return len(open_seqs)


def _until(predicate, timeout_s: float, what: str) -> float:
    """Poll `predicate` every ms until it holds; the ms it took."""
    t0 = time.perf_counter()
    while not predicate():
        if time.perf_counter() - t0 > timeout_s:
            raise RuntimeError(f"{what} not within {timeout_s} s")
        time.sleep(0.001)
    return (time.perf_counter() - t0) * 1e3


def _heal(stack: _MasterStack, pod) -> float:
    """The partition lifted, then tracked calls on both planes until ApiHealth
    reads healthy; the ms from the heal."""
    app = stack.app
    t0 = time.perf_counter()
    stack.cluster.kube.set_partitioned(False)
    for _ in range(10):
        if app.apihealth.state() == "healthy":
            break
        app.kube.get_pod(pod.namespace, pod.name)
        app.kube.patch_pod(pod.namespace, pod.name, {"metadata": {"labels": {}}})
    if app.apihealth.state() != "healthy":
        raise RuntimeError(f"ApiHealth after the heal: {app.apihealth.payload()}")
    return (time.perf_counter() - t0) * 1e3


def _apihealth(stack: _MasterStack) -> dict:
    status, body, _ = stack.http("GET", "/apihealth")
    if status != 200:
        raise RuntimeError(f"/apihealth: {status} {body!r}")
    return json.loads(body)


def _degraded_healthy(stack: _MasterStack, dev_dir: str, repeats: int, live: bool,
                      lists: list) -> dict:
    """(a) `repeats` HTTP round trips of 1 GPU through the store-backed
    registry; /healthz "ok", /apihealth healthy with the registry's cache
    age and an empty queue; the registry's LIST counted through the store."""
    flow = _master_flow(stack, dev_dir, 1, repeats, "round-trip", live=live)
    status, body, _ = stack.http("GET", "/healthz", token=None)
    pane = _apihealth(stack)
    if (status, body) != (200, "ok\n") or pane["api"]["state"] != "healthy" \
            or "worker_pods" not in pane["store"]["cacheAgesS"] \
            or pane["store"]["writeBehind"]["pending"] != 0 or not lists \
            or stack.app.registry.store is not stack.app.store:
        raise RuntimeError(f"the healthy seam: /healthz {status} {body!r}, /apihealth {pane}, "
                           f"{len(lists)} registry LIST(s) through the store")
    return {"add_ms": flow["add_ms"], "remove_ms": flow["remove_ms"], "healthz": body,
            "apihealth": pane, "registry_lists": len(lists)}


def _degraded_writes(stack: _MasterStack, dev_dir: str, live: bool) -> dict:
    """(b) A write partition around a remove: the plane driven down, 3 stamps
    and a CAS stamp deferred (4 on disk), the remove 200 with its slave's
    release deferred into the ledger and the next release's probe trying one
    record, an add refused (500) with nothing mounted; healed, the flush
    applies the 3 once each and drops the CAS one (a newer writer's seq 5),
    the queue reopened from disk holds nothing, the releases retried, books
    == mounts == ledger."""
    cluster, app, node = stack.cluster, stack.app, stack.cluster.node_name
    service, kube = stack.services[node], stack.cluster.kube
    pod = cluster.add_target_pod("tenant-degraded-writes")
    free = cluster.free_gpu_count(node)
    status, text, _ = stack.http("GET", _add_path(pod, 1))
    if status != 200:
        raise RuntimeError(f"add before the write partition: {status} {text!r}")
    uuids = stack.held(node, pod)
    kube.set_partitioned(True, mode="writes")
    t0 = time.perf_counter()
    while app.apihealth.plane_state("write") != "down":
        try:
            app.kube.patch_pod(pod.namespace, pod.name, {"metadata": {"labels": {}}})
        except PartitionError:
            pass
        if time.perf_counter() - t0 > 10.0:
            raise RuntimeError(f"the write plane not down: {app.apihealth.payload()}")
        time.sleep(0.01)
    down_ms = (time.perf_counter() - t0) * 1e3
    status, healthz, _ = stack.http("GET", "/healthz", token=None)
    deferred0 = DEFERRED_WRITES.total()
    for i, annotation in enumerate(DEGRADED_STAMPS):
        app.store.stamp_annotation(pod.namespace, pod.name, annotation, f"stamp-{i}")
    app.store.stamp_annotation(pod.namespace, pod.name, DEGRADED_CAS, json.dumps({"seq": 1}))
    deferred = DEFERRED_WRITES.total() - deferred0
    on_disk = _queued_on_disk(app.store.queue.directory)
    if status != 200 or healthz != "ok\napi: down\n" or deferred != 4 or on_disk != 4:
        raise RuntimeError(f"the write partition: /healthz {status} {healthz!r}, {deferred} "
                           f"deferred, {on_disk} on disk")
    released0 = SLAVE_RELEASE_DEFERRED.total()
    status, text, remove_ms = stack.http("POST", _remove_path(pod), {"uuids": ",".join(uuids)})
    _no_gpu_node(cluster, node, dev_dir, "the remove in the write partition")
    pending = service.ledger.pending_releases()
    if status != 200 or len(pending) != 1 or SLAVE_RELEASE_DEFERRED.total() - released0 != 1:
        raise RuntimeError(f"the remove in the write partition: {status} {text!r}, pending "
                           f"{pending}")
    # the next release's probe, with two more records queued: one doomed delete
    for i in range(2):
        service.ledger.queue_release(cluster.cfg.pool_namespace, [f"{pod.name}-queued-{i}"])
    attempts: list[str] = []
    delete = kube.delete_pod
    kube.delete_pod = lambda ns, name, **kw: (attempts.append(name), delete(ns, name, **kw))[1]
    try:
        probe = service.probe_pending_releases()
    finally:
        del kube.delete_pod
    if len(attempts) != 1 or probe != {"completed": 0, "pending": 3}:
        raise RuntimeError(f"the next release's probe: {attempts} tried, {probe}")
    # the add: its slave pod cannot be made; the deferred one still books its GPU
    slaves = _slave_pods(cluster, pod)
    refused, refusal, refused_ms = stack.http("GET", _add_path(pod, 1))
    if refused != 500 or _slave_pods(cluster, pod) != slaves or len(slaves) != 1 \
            or cluster.free_gpu_count(node) != free - 1:
        raise RuntimeError(f"the add in the write partition: {refused} {refusal!r}, slave pods "
                           f"{_slave_pods(cluster, pod)}, {cluster.free_gpu_count(node)} free")
    _no_gpu_node(cluster, node, dev_dir, "the refused add")
    # the heal: a newer writer's CAS value first, then calls on both planes
    kube.set_partitioned(False)
    kube.patch_pod(pod.namespace, pod.name, {"metadata": {"annotations": {
        DEGRADED_CAS: json.dumps({"seq": 5})}}})
    patched: list[str] = []
    patch = kube.patch_pod
    kube.patch_pod = lambda ns, name, body: (patched.extend(
        body.get("metadata", {}).get("annotations", {})), patch(ns, name, body))[1]
    replayed0 = WRITEBEHIND_REPLAYED.snapshot()
    healed_at: list[float] = []
    # the store's subscriber starts the flush at the transition; this one
    # (subscribed after it) stamps the transition's time
    app.apihealth.subscribe(lambda old, new: healed_at.append(time.perf_counter())
                            if new == "healthy" else None)
    try:
        heal_ms = _heal(stack, pod)
        _until(lambda: app.store.queue.pending_count() == 0, 10.0, "the flush")
        flush_ms = (time.perf_counter() - healed_at[0]) * 1e3
    finally:
        del kube.patch_pod
    replayed = {dict(k).get("outcome"): v - replayed0.get(k, 0.0)
                for k, v in WRITEBEHIND_REPLAYED.snapshot().items()}
    flush = {"applied": int(replayed.get("applied", 0)),
             "lost_cas": int(replayed.get("lost-cas", 0))}
    annotations = Pod(kube.get_pod(pod.namespace, pod.name)).annotations
    if flush != {"applied": 3, "lost_cas": 1} \
            or sorted(a for a in patched if a in DEGRADED_STAMPS + (DEGRADED_CAS,)) \
            != sorted(DEGRADED_STAMPS) \
            or [annotations.get(a) for a in DEGRADED_STAMPS] != ["stamp-0", "stamp-1", "stamp-2"] \
            or json.loads(annotations[DEGRADED_CAS]) != {"seq": 5}:
        raise RuntimeError(f"the flush: {replayed}, patched {patched}, annotations "
                           f"{annotations}")
    reopened = WriteBehindQueue(app.store.queue.directory)
    reopened_pending = reopened.pending_count()
    reopened.close()
    retried = service.retry_pending_releases()
    if reopened_pending or retried != {"completed": 3, "pending": 0}:
        raise RuntimeError(f"after the heal: {reopened_pending} pending on disk, the releases "
                           f"{retried}")
    _released(cluster, pod, free)
    books = _books_mounts_ledger(stack, pod, dev_dir)
    return {"down_ms": down_ms, "healthz": healthz, "deferred": deferred, "on_disk": on_disk,
            "remove_ms": remove_ms, "release_attempts": [len(attempts)], "probe": probe,
            "refused": (refused, refusal.strip()), "refused_ms": refused_ms, "heal_ms": heal_ms,
            "flush": flush, "flush_ms": flush_ms, "reopened_pending": reopened_pending,
            "retried": retried, "books": books}


#: (b')'s machine: the quiesce's ack wait, long enough for the write plane
#: to go down inside it (DEGRADED_HEALTH's 0.5 s), and no wait on the resume
DEGRADED_MIGRATE_KNOBS = dict(migrate_quiesce_timeout_s=3.0, migrate_resume_timeout_s=0.3,
                              migrate_poll_interval_s=0.02)


def _degraded_migration_traffic(stack: _MasterStack, dev_dir: str) -> dict:
    """(b') The elastic and migration routes' writes in a write partition. A
    GPU added to a source pod, then POST /migrate to a destination pod on the
    node; while the machine waits in the quiesce for an ack no tenant sends,
    the write plane goes down: PUT /intents is refused (500; a user's CRUD is
    never deferred, as the reference's), and the quiesce's end meets the
    partition, its journal persist and the pause's (``paused_for_api``)
    defer into the write-behind queue, the GPU still on the source. Healed,
    the flush lands the journal once, and the machine drains, remounts and
    verifies: succeeded, the GPU on the destination (books == mounts ==
    ledger), then removed. The two deferred persists' ms are their
    ``migrate.journal_persist`` spans on the migration's trace."""
    from gpumounter_tpu_torch.migrate.journal import ANNOT_JOURNAL, parse_journal
    cluster, app, kube, node = stack.cluster, stack.app, stack.cluster.kube, \
        stack.cluster.node_name
    src = cluster.add_target_pod("tenant-degraded-mig-src")
    dst = cluster.add_target_pod("tenant-degraded-mig-dst")
    status, text, _ = stack.http("GET", _add_path(src, 1))
    if status != 200:
        raise RuntimeError(f"add before the migration: {status} {text!r}")
    uuids = stack.held(node, src)
    cfg = app.migrations.cfg
    app.migrations.cfg = dataclasses.replace(cfg, **DEGRADED_MIGRATE_KNOBS)
    try:
        status, body, begin_ms = stack.http("POST", "/migrate", payload={
            "source": {"namespace": src.namespace, "pod": src.name},
            "destination": {"namespace": dst.namespace, "pod": dst.name}})
        if status != 200:
            raise RuntimeError(f"POST /migrate: {status} {body}")
        mid = json.loads(body)["id"]
        _until(lambda: "tpumounter.io/migration-phase" in Pod(kube.get_pod(
            src.namespace, src.name)).annotations, 10.0, "the quiesce's stamp")
        kube.set_partitioned(True, mode="writes")
        partitioned_at = time.time()
        t0 = time.perf_counter()
        while app.apihealth.plane_state("write") != "down":
            try:
                app.kube.patch_pod(src.namespace, src.name, {"metadata": {"labels": {}}})
            except PartitionError:
                pass
            if time.perf_counter() - t0 > 10.0:
                raise RuntimeError(f"the write plane not down: {app.apihealth.payload()}")
            time.sleep(0.01)
        put_status, refusal, put_ms = stack.http(
            "PUT", f"/intents/{src.namespace}/{src.name}", payload={"desiredChips": 1})
        deferred0, replayed0 = DEFERRED_WRITES.total(), WRITEBEHIND_REPLAYED.snapshot()
        if (app.migrations.get(mid) or {}).get("phase") != "quiesce":
            raise RuntimeError(f"the machine left the quiesce before the write plane went "
                               f"down: {app.migrations.get(mid)}")
        _until(lambda: (app.migrations.get(mid) or {}).get("paused_for_api"), 30.0,
               "the machine's pause")
        paused = app.migrations.get(mid)
        deferred = DEFERRED_WRITES.total() - deferred0
        stored = parse_journal(Pod(kube.get_pod(src.namespace, src.name)).annotations)
        if put_status != 500 or deferred != 2 or app.store.queue.pending_count() < 1 \
                or stored is None or stored["phase"] != "quiesce" or paused["outcome"] \
                or stack.held(node, src) != uuids or stack.held(node, dst):
            raise RuntimeError(f"the write partition: PUT /intents {put_status} {refusal!r}, "
                               f"{deferred} deferred, {app.store.queue.pending_count()} "
                               f"pending, the stored journal {stored}, the machine {paused}")
        healed_at: list[float] = []
        app.apihealth.subscribe(lambda old, new: healed_at.append(time.perf_counter())
                                if new == "healthy" else None)
        # the persists made in the partition start before its lift: the
        # machine, resumed by the heal, may persist again before _heal returns
        lifted_wall = time.time()
        heal_ms = _heal(stack, src)
        _until(lambda: app.store.queue.pending_count() == 0, 10.0, "the journal's flush")
        flush_ms = (time.perf_counter() - healed_at[0]) * 1e3
        journal = app.migrations.wait(mid, timeout_s=120.0)
    finally:
        app.migrations.cfg = cfg
    applied = sum(v - replayed0.get(k, 0.0) for k, v in WRITEBEHIND_REPLAYED.snapshot().items()
                  if dict(k).get("outcome") == "applied")
    landed = parse_journal(Pod(kube.get_pod(src.namespace, src.name)).annotations)
    persists = [sp for sp in _trace_spans(stack, journal["trace_id"])
                if sp["name"] == "migrate.journal_persist"
                and partitioned_at <= sp["start"] < lifted_wall]
    if journal.get("outcome") != "succeeded" or journal["dest_chips"] != uuids \
            or applied < 1 or landed is None or landed["outcome"] != "succeeded" \
            or len(persists) != 2 or ANNOT_JOURNAL not in Pod(kube.get_pod(
                src.namespace, src.name)).annotations:
        raise RuntimeError(f"after the heal: journal {journal}, {applied} applied, landed "
                           f"{landed}, the deferred persists' spans {persists}")
    books = _books_mounts_ledger(stack, dst, dev_dir)
    status, text, _ = stack.http("POST", _remove_path(dst), {"uuids": ",".join(uuids)})
    if books != uuids or status != 200 or stack.held(node, dst):
        raise RuntimeError(f"the destination: books {books}, the remove {status} {text!r}")
    return {"put_refused": (put_status, refusal.strip()),
            "put_ms": put_ms, "begin_ms": begin_ms, "deferred": deferred,
            "persist_ms": [sp["duration_s"] * 1e3 for sp in persists],
            "paused_phase": paused["phase"], "heal_ms": heal_ms, "flush_ms": flush_ms,
            "applied": applied, "outcome": journal["outcome"],
            "phases_s": journal["phase_durations_s"], "id": mid}


def _degraded_reads(stack: _MasterStack, dev_dir: str, live: bool, on_healed=None) -> dict:
    """(c) A read partition around an add: the registry answers from its
    cache, the store's worker LIST is served stale (its age on /apihealth),
    the add fails fast at the pod read (500) with no worker call, a stamp
    lands directly; healed, the add mounts the GPU (on_healed(uuids, dev_dir)
    while it is mounted), and the remove."""
    cluster, app, node = stack.cluster, stack.app, stack.cluster.node_name
    kube = cluster.kube
    pod = cluster.add_target_pod("tenant-degraded-reads")
    free = cluster.free_gpu_count(node)
    calls: list[str] = []
    factory = app._client_factory
    app._client_factory = lambda address: (calls.append(address), factory(address))[1]
    stale0 = STALE_READS.total()
    kube.set_partitioned(True, mode="reads")
    try:
        address = app.registry.worker_address(node)
        stale = app.store.list_worker_pods()
        pane = _apihealth(stack)
        refused, refusal, refused_ms = stack.http("GET", _add_path(pod, 1))
        app.store.stamp_annotation(pod.namespace, pod.name, DEGRADED_STAMPS[0], "direct")
        queued = app.store.queue.pending_count()
    finally:
        app._client_factory = factory
    stale_reads = STALE_READS.total() - stale0
    if address is None or not stale or stale_reads != 1 or refused != 500 or calls \
            or queued or "worker_pods" not in pane["store"]["cacheAgesS"]:
        raise RuntimeError(f"the read partition: worker {address}, {len(stale)} stale worker(s), "
                           f"{stale_reads} stale read(s), add {refused} {refusal!r}, worker calls "
                           f"{calls}, {queued} queued, /apihealth {pane}")
    heal_ms = _heal(stack, pod)
    if Pod(kube.get_pod(pod.namespace, pod.name)).annotations.get(DEGRADED_STAMPS[0]) != "direct":
        raise RuntimeError("the stamp in the read partition did not land")
    status, text, add_ms = stack.http("GET", _add_path(pod, 1))
    if status != 200:
        raise RuntimeError(f"the add after the heal: {status} {text!r}")
    uuids = _books_mounts_ledger(stack, pod, dev_dir)
    _check_nodes(cluster.backend, uuids, dev_dir, live)
    if on_healed is not None:
        on_healed(uuids, dev_dir)
    status, text, remove_ms = stack.http("POST", _remove_path(pod), {"uuids": ",".join(uuids)})
    if status != 200:
        raise RuntimeError(f"the remove after the heal: {status} {text!r}")
    _no_gpu_node(cluster, node, dev_dir, "the remove after the heal")
    _released(cluster, pod, free)
    return {"stale_reads": stale_reads, "cache_age_s": pane["store"]["cacheAgesS"]["worker_pods"],
            "refused": (refused, refusal.strip()), "refused_ms": refused_ms,
            "worker_calls": len(calls), "queued": queued, "heal_ms": heal_ms,
            "add_ms": add_ms, "remove_ms": remove_ms, "uuids": uuids}


def _degraded_costs(stack: _MasterStack, queue_dir: str, iters: int) -> dict:
    """(d) Each `iters` times (us, host clock): a get_pod on the raw fake and
    through the health-tracked client, a worker LIST through the cached store
    and through the store it wraps, and one enqueue with its fsync (a queue of
    its own in `queue_dir`)."""
    cluster, app = stack.cluster, stack.app
    pod = cluster.add_target_pod("tenant-degraded-costs")
    queue = WriteBehindQueue(queue_dir)
    n = iter(range(10 ** 6))
    try:
        return {
            "raw_call_us": _median_us(lambda: cluster.kube.get_pod(pod.namespace, pod.name),
                                      iters),
            "tracked_call_us": _median_us(lambda: app.kube.get_pod(pod.namespace, pod.name),
                                          iters),
            "inner_read_us": _median_us(app.store.inner.list_worker_pods, iters),
            "cached_read_us": _median_us(app.store.list_worker_pods, iters),
            "enqueue_us": _median_us(lambda: queue.enqueue(
                pod.namespace, pod.name, f"tpumounter.io/cost-{next(n)}", "v"), iters)}
    finally:
        queue.close()


def degraded_check(device="cuda", *, dev_dir: str | None = None, ns_pid: int | None = None,
                   cgroup_dirs=(), identity: str = "nvml", repeats: int = 3,
                   queue_root: str | None = None, cost_iters: int = 20,
                   on_healed=None) -> dict:
    """The master's store through an API outage, over HTTP and gRPC
    (``_MasterStack`` with the default ``CachedMasterStore``, the worker with
    a ledger, the write-behind queue and the ledger in a new directory under
    `queue_root`, by default a temporary one). The "API server" is the
    cluster's ``FakeKubeClient``, partitioned by ``set_partitioned`` and
    shared by the master and the worker, whose calls feed the process's
    ApiHealth; the check drops the process's machines first and last
    (``k8s.health.reset_all``), so that its thresholds (DEGRADED_HEALTH) are
    the ones in force. Without grpcio it raises ``ModuleNotFoundError``
    naming grpcio.

    (a) ``_degraded_healthy``: `repeats` round trips through the new seam.
    (b) ``_degraded_writes``: a write partition around a remove, then
    ``_degraded_migration_traffic``: an intent's PUT refused and a
    migration's journal persists deferred while its machine pauses, in a
    second write partition, then the migration finished after the heal. (c)
    ``_degraded_reads``: a read partition around an add; on_healed(uuids,
    dev_dir) runs while the GPU added after the heal is mounted. (d)
    ``_degraded_costs``: `cost_iters` tracked calls, cached reads and
    enqueues.

    On the card (device="cuda") the flows run on the live
    ``NvidiaDeviceBackend`` (`dev_dir`, `ns_pid`, `cgroup_dirs`, `identity`
    as in ``mount_check``), and without CAP_MKNOD it raises; on the CPU on a
    fake host of 8 GPUs. Runs on the card unless the caller passes
    device="cpu".

    Returns {"cap_mknod", "health" (the thresholds), "live" or "fake": {
    "healthy", "writes", "migration_traffic", "reads"}, the other None,
    "costs"}; ms and us on
    the host clock."""
    device = resolve_device(device)
    report = {"cap_mknod": has_cap_mknod(), "health": dict(DEGRADED_HEALTH), "live": None,
              "fake": None}
    if device.type == "cuda" and not report["cap_mknod"]:
        raise RuntimeError("degraded_check on the card needs CAP_MKNOD: its adds and removes "
                           "must be the card's own GPU's")
    root = tempfile.mkdtemp(prefix="degraded-check-")
    state = tempfile.mkdtemp(prefix="degraded-state-", dir=queue_root)
    k8s_health.reset_all()
    try:
        cfg = Config(auth_mode="token", auth_token=secrets.token_hex(16),
                     ledger_dir=os.path.join(state, "ledger"),
                     writebehind_dir=os.path.join(state, "writebehind"), **DEGRADED_HEALTH)
        if device.type == "cuda":
            cluster = FakeCluster(NvidiaDeviceBackend("/dev", identity=make_identity(identity)),
                                  cfg=cfg)
            target, dirs = _live_target(root, dev_dir, cgroup_dirs)
            live, key = True, "live"
        else:
            cluster = FakeCluster.with_fake_gpus(os.path.join(root, "fake"), 8, cfg=cfg)
            target, dirs, ns_pid = os.path.join(root, "fake-tenant-dev"), [], None
            os.makedirs(target)
            live, key = False, "fake"
        with _MasterStack(cluster, {cluster.node_name: target}, ns_pid, dirs) as stack:
            lists: list[int] = []
            list_workers = stack.app.store.list_worker_pods
            stack.app.store.list_worker_pods = lambda: (lists.append(1), list_workers())[1]
            report[key] = {"healthy": _degraded_healthy(stack, target, repeats, live, lists)}
            del stack.app.store.list_worker_pods
            report[key]["writes"] = _degraded_writes(stack, target, live)
            report[key]["migration_traffic"] = _degraded_migration_traffic(stack, target)
            report[key]["reads"] = _degraded_reads(stack, target, live, on_healed)
            report["costs"] = _degraded_costs(stack, os.path.join(state, "cost-queue"),
                                              cost_iters)
    finally:
        k8s_health.reset_all()
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(state, ignore_errors=True)
    return report


# --- sharded masters, epoch stamping, the batch's owner routing, the warm pool ---

#: the stale owner's lease (c): short, so that the takeover comes within a second
SHARD_POOL_LEASE_S = 0.3


class _NoRedirect(urllib.request.HTTPRedirectHandler):
    """An opener's handler that leaves a 307 to the caller."""

    def redirect_request(self, *args, **kwargs):
        return None


def _unfollowed(base: str, path: str, token: str) -> tuple[int, str, dict]:
    """(status, body, headers) of a GET whose redirect is not followed."""
    req = urllib.request.Request(base + path, headers={"Authorization": f"Bearer {token}"})
    try:
        with urllib.request.build_opener(_NoRedirect).open(req, timeout=60) as resp:
            return resp.status, resp.read().decode(), dict(resp.headers)
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode(), dict(exc.headers)


def _span(tid: str, name: str) -> dict:
    """The last span named `name` of trace `tid` in this process's ring."""
    spans = [s for s in trace.TRACER.ring.spans_for(tid) if s["name"] == name]
    if not spans:
        raise RuntimeError(f"trace {tid} holds no {name} span")
    return spans[-1]


def _held_uuids(service, pod) -> list[str]:
    """The UUIDs the pod holds through its slave pods, found by owner label
    (an adopted warm holder keeps its own name)."""
    slaves = {p.name for p in service.allocator.slave_pods_for(pod)}
    return [d.uuid for d in service.collector.get_pod_devices(pod.name, pod.namespace, slaves)]


def _node_state(stack: _MasterStack, pod, dev_dir: str) -> tuple:
    """What a refused call must leave as it was: the free GPUs, the pod's
    slave pods, the target's entries, the ledger's appends and holdings."""
    cluster = stack.cluster
    ledger = stack.services[cluster.node_name].ledger
    slaves = sorted(Pod(p).name for p in cluster.kube.list_pods(
        cluster.cfg.pool_namespace, label_selector=f"tpumounter.io/owner-uid={pod.uid}"))
    return (cluster.free_gpu_count(), slaves, sorted(os.listdir(dev_dir)),
            LEDGER_APPENDS.total(), {k: sorted(v) for k, v in ledger.net_holdings().items()})


def _pooled_round(stack: _MasterStack, pod, dev_dir: str, live: bool, warm: bool,
                  base: str) -> dict:
    """One HTTP add of 1 GPU at `base`, with the pool's outcome: a warm hit
    (an adopted holder) or a cold miss, read off the counters and the add's
    ``mount.slave_pod_schedule`` span."""
    from gpumounter_tpu_torch.allocator.pool import WARM_POOL_HITS, WARM_POOL_MISSES
    cluster = stack.cluster
    service = stack.services[cluster.node_name]
    hits, misses = WARM_POOL_HITS.total(), WARM_POOL_MISSES.total()
    status, body, add_ms, headers = _http_with_headers(base, "GET", _add_path(pod, 1),
                                                       stack.token)
    tid = next((v for k, v in headers.items() if k.lower() == trace.TRACE_HEADER), "")
    if (status, body) != (200, "Add GPU Success\n"):
        raise RuntimeError(f"GET {_add_path(pod, 1)}: {status} {body!r}")
    attrs = _span(tid, "mount.slave_pod_schedule")
    got = (WARM_POOL_HITS.total() - hits, WARM_POOL_MISSES.total() - misses,
           attrs["attrs"]["pool_hit"], attrs["attrs"]["pool_gap"])
    if got != ((1.0, 0.0, 1, 0) if warm else (0.0, 1.0, 0, 1)):
        raise RuntimeError(f"{'warm' if warm else 'cold'} add: hits, misses, the span's "
                           f"pool_hit and pool_gap {got}")
    uuids = _held_uuids(service, pod)
    if len(uuids) != 1:
        raise RuntimeError(f"{len(uuids)} GPU(s) held after the add of 1: {uuids}")
    _check_nodes(cluster.backend, uuids, dev_dir, live)
    slaves = [Pod(p) for p in cluster.kube.list_pods(
        cluster.cfg.pool_namespace, label_selector=f"tpumounter.io/owner-uid={pod.uid}")]
    if warm != all(s.name.startswith("warm-slave-") for s in slaves):
        raise RuntimeError(f"the {'warm' if warm else 'cold'} add's slave pods: "
                           f"{[s.name for s in slaves]}")
    return {"add_ms": add_ms, "schedule_ms": attrs["duration_s"] * 1e3, "uuids": uuids,
            "tid": tid}


def _remove_one(stack: _MasterStack, pod, uuids: list[str], dev_dir: str,
                base: str | None = None) -> float:
    """The HTTP remove of `uuids`; the nodes must be gone."""
    status, body, ms = _http(base or stack.base, "POST", _remove_path(pod), stack.token,
                             {"uuids": ",".join(uuids)})
    if (status, body) != (200, f"Remove {len(uuids)} GPUs Success\n"):
        raise RuntimeError(f"POST {_remove_path(pod)} {uuids}: {status} {body!r}")
    for uuid in uuids:
        if os.path.lexists(os.path.join(dev_dir,
                                        stack.cluster.backend.device_by_uuid(uuid).basename)):
            raise RuntimeError(f"{uuid}'s node still in {dev_dir} after the remove")
    return ms


def _pool_flows(stack: _MasterStack, dev_dir: str, repeats: int, live: bool,
                on_pooled) -> dict:
    """(a): two replicas on their renew loops, the worker with a pool of 1.
    The node's owner must stamp its shard's epoch into the worker's ledger.
    `repeats` warm adds at the owner (each adopts the holder; the remove;
    the refill restores it), then the node drained and `repeats` cold adds.
    The set-up steps, the tenant child and the whole flow are timed, and
    the refills refused on the way counted: the owner must still hold its
    shard at the end, however long they took."""
    cluster, node = stack.cluster, stack.cluster.node_name
    service = stack.services[node]
    pool = service.pool
    owner = stack.owner(node)
    shards = stack.apps[owner].shards
    base = stack.bases[owner]
    epoch = shards.node_epoch(node)
    if epoch < 1 or shards.owned_shards() != {shards.owner_shard(node)}:
        raise RuntimeError(f"the owner replica holds {shards.owned_shards()}, epoch {epoch}")
    from gpumounter_tpu_torch.allocator.pool import WARM_POOL_REFILL_FAILURES
    failures = WARM_POOL_REFILL_FAILURES.total()
    t_flow = time.perf_counter()
    pool.ensure_node(node)
    t0 = time.perf_counter()
    out = {"epoch": epoch, "ensure_node_ms": (t0 - t_flow) * 1e3, "warm": [], "cold": [],
           "refill_ms": [], "child_ms": None}
    if not pool.wait_ready(node, 1, timeout_s=30.0):
        raise RuntimeError("the warm pool never filled")
    out["first_fill_ms"] = (time.perf_counter() - t0) * 1e3
    pod = cluster.add_target_pod("tenant-pooled")
    for i in range(repeats):
        got = _pooled_round(stack, pod, dev_dir, live, warm=True, base=base)
        if service.ledger.epoch() != epoch:
            raise RuntimeError(f"the worker's ledger holds epoch {service.ledger.epoch()}, the "
                               f"replica stamped {epoch}")
        if on_pooled is not None and i == 0:
            t0 = time.perf_counter()
            on_pooled(got["uuids"], dev_dir)
            out["child_ms"] = (time.perf_counter() - t0) * 1e3
        got["remove_ms"] = _remove_one(stack, pod, got["uuids"], dev_dir, base=base)
        t0 = time.perf_counter()
        if not pool.wait_ready(node, 1, timeout_s=30.0):
            raise RuntimeError("the refill did not restore the pool after the remove")
        out["refill_ms"].append((time.perf_counter() - t0) * 1e3)
        out["warm"].append(got)
    out["drained"] = pool.set_drained(node, True)
    if out["drained"] != 1 or pool.ready_count(node) != 0:
        raise RuntimeError(f"the drain released {out['drained']}, "
                           f"{pool.ready_count(node)} ready")
    for _ in range(repeats):
        got = _pooled_round(stack, pod, dev_dir, live, warm=False, base=base)
        got["remove_ms"] = _remove_one(stack, pod, got["uuids"], dev_dir, base=base)
        out["cold"].append(got)
    pool.set_drained(node, False)
    out["ledger_epoch"] = service.ledger.epoch()
    out["flow_s"] = time.perf_counter() - t_flow
    # refills refused while the node's GPUs were all held (on a node of one
    # GPU: each time a tenant held the adopted one)
    out["refill_failures"] = WARM_POOL_REFILL_FAILURES.total() - failures
    out["lease_s"], out["renew_s"] = shards.duration_s, shards.renew_interval_s
    if shards.owner_shard(node) not in shards.owned_shards() or shards.node_epoch(node) != epoch:
        raise RuntimeError(f"after {out['flow_s']:.1f} s the owner holds "
                           f"{shards.owned_shards()} at epoch {shards.node_epoch(node)}")
    return out


def _two_replicas(stack: _MasterStack, dev_dir: str, repeats: int, live: bool) -> dict:
    """(b): two replicas on their renew loops, one lease each. /addgpu at
    the non-owner answers 307 to the owner (followed, it mounts);
    /batch/addgpu at the non-owner is proxied once to the owner and mounts;
    a direct batch beside it."""
    from gpumounter_tpu_torch.rpc.http_failover import MasterEndpoints
    cluster, node = stack.cluster, stack.cluster.node_name
    owner = stack.owner(node)
    other = 1 - owner
    held = [sorted(app.shards.owned_shards()) for app in stack.apps]
    if sorted(held) != [[0], [1]]:
        raise RuntimeError(f"the replicas hold {held}")
    pod = cluster.add_target_pod("tenant-sharded")
    path = _add_path(pod, 1)
    status, body, headers = _unfollowed(stack.bases[other], path, stack.token)
    location = headers.get("Location")
    if status != 307 or location != stack.bases[owner] + path:
        raise RuntimeError(f"GET {path} at the non-owner: {status} {body!r}, Location "
                           f"{location!r}")
    t0 = time.perf_counter()
    answer = MasterEndpoints(stack.bases[other], token=stack.token).request("GET", path)
    followed_ms = (time.perf_counter() - t0) * 1e3
    if answer != (200, "Add GPU Success\n"):
        raise RuntimeError(f"the followed redirect: {answer}")
    service = stack.services[node]
    uuids = _held_uuids(service, pod)
    _check_nodes(cluster.backend, uuids, dev_dir, live)
    _remove_one(stack, pod, uuids, dev_dir, base=stack.bases[owner])
    out = {"owner": owner, "redirect": location, "followed_ms": followed_ms, "proxied_ms": [],
           "direct_ms": [], "epochs": [app.shards.node_epoch(node) for app in stack.apps]}
    batch = {"targets": [{"namespace": pod.namespace, "pod": pod.name, "gpus": 1}]}
    for _ in range(repeats):
        for key, base in (("proxied_ms", stack.bases[other]), ("direct_ms", stack.bases[owner])):
            status, text, ms, headers = _http_with_headers(base, "POST", "/batch/addgpu",
                                                           stack.token, payload=batch)
            results = json.loads(text)["results"] if status == 200 else text
            if status != 200 or results[0].get("result") != "Success" or len(
                    results[0].get("uuids", [])) != 1:
                raise RuntimeError(f"{key[:-3]} batch: {status} {results}")
            names = [s["name"] for s in trace.TRACER.ring.spans_for(
                headers.get(trace.RESPONSE_HEADER, ""))]
            want = 2 if key == "proxied_ms" else 1
            if names.count("http.batch_add") != want or ("proxy.batch" in names) != (want == 2) \
                    or "worker.AddGPU" not in names:
                raise RuntimeError(f"{key[:-3]} batch's trace: {names}")
            _check_nodes(cluster.backend, results[0]["uuids"], dev_dir, live)
            out[key].append(ms)
            _remove_one(stack, pod, results[0]["uuids"], dev_dir, base=stack.bases[owner])
    forwarded = _forwarded_batch(stack.bases[other], stack.token, batch)
    if forwarded != "NotOwner":
        raise RuntimeError(f"a forwarded batch at the non-owner: {forwarded}")
    out["forwarded"] = forwarded
    return out


def _forwarded_batch(base: str, token: str, batch: dict) -> str:
    """The result of a batch that arrives forwarded (a peer's proxy): the
    replica answers it itself, never hops again."""
    req = urllib.request.Request(base + "/batch/addgpu", data=json.dumps(batch).encode(),
                                 method="POST", headers={"Authorization": f"Bearer {token}",
                                                         "Content-Type": "application/json",
                                                         FORWARDED_HEADER: "1"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())["results"][0]["result"]


class _LeaseWrites:
    """A replica's view of the API whose lease writes can be cut off (the
    fake's PartitionError), while every other call, and every other
    replica's, goes through."""

    def __init__(self, kube):
        self._kube = kube
        self.partitioned = False

    def __getattr__(self, name):
        return getattr(self._kube, name)

    def update_lease(self, namespace: str, name: str, manifest: dict) -> dict:
        if self.partitioned:
            raise PartitionError(f"lease {namespace}/{name}: this replica's writes are "
                                 f"partitioned")
        return self._kube.update_lease(namespace, name, manifest)


def _stale_owner(stack: _MasterStack, dev_dir: str, live: bool) -> dict:
    """(c): the owner's live add is held between its shard gate and its
    worker call (a paused process) while its lease writes are partitioned
    and the other replica takes the shard over with epoch + 1; the new
    owner's add mounts; then the held add goes on at the old epoch and is
    fenced by the worker: 503 with Retry-After, and nothing mounted, booked
    or written to the ledger. The new owner's remove frees the GPU."""
    cluster, node = stack.cluster, stack.cluster.node_name
    owner = stack.owner(node)
    old, new = stack.apps[owner], stack.apps[1 - owner]
    shard = old.shards.owner_shard(node)
    leases = _LeaseWrites(cluster.kube)
    old.shards.kube = leases
    pod = cluster.add_target_pod("tenant-stale")
    stale_epoch = old.shards.node_epoch(node)
    # the old owner's add and remove: the worker keeps its epoch. A lease
    # of 0.3 s: every request here is preceded by a renew pass
    stack.acquire()
    status, body, _ = _http(stack.bases[owner], "GET", _add_path(pod, 1), stack.token)
    if (status, body) != (200, "Add GPU Success\n"):
        raise RuntimeError(f"the owner's first add: {status} {body!r}")
    service = stack.services[node]
    uuids = _held_uuids(service, pod)
    stack.acquire()
    _remove_one(stack, pod, uuids, dev_dir, base=stack.bases[owner])
    gate_passed, resume = threading.Event(), threading.Event()
    factory = old._client_factory

    def paused(address):
        gate_passed.set()
        if not resume.wait(30.0):
            raise RuntimeError("the held add was never resumed")
        return factory(address)

    old._client_factory = paused
    answer: dict = {}

    def stale_add():
        answer["got"] = _http_with_headers(stack.bases[owner], "GET", _add_path(pod, 1),
                                           stack.token)

    thread = threading.Thread(target=stale_add, name="stale-add", daemon=True)
    stack.acquire()
    thread.start()
    try:
        if not gate_passed.wait(30.0):
            raise RuntimeError("the owner's add never passed its shard gate")
        leases.partitioned = True
        t0 = time.perf_counter()
        while shard not in new.shards.owned_shards():
            if time.perf_counter() - t0 > 10.0:
                raise RuntimeError("the other replica never took the shard over")
            stack.acquire()
            time.sleep(0.02)
        takeover_ms = (time.perf_counter() - t0) * 1e3
        fresh_epoch = new.shards.node_epoch(node)
        if fresh_epoch != stale_epoch + 1 or old.shards.node_epoch(node) != stale_epoch:
            raise RuntimeError(f"epochs after the takeover: new {fresh_epoch}, old "
                               f"{old.shards.node_epoch(node)}, before {stale_epoch}")
        stack.acquire()
        status, body, new_add_ms = _http(stack.bases[1 - owner], "GET", _add_path(pod, 1),
                                         stack.token)
        if (status, body) != (200, "Add GPU Success\n"):
            raise RuntimeError(f"the new owner's add: {status} {body!r}")
        uuids = _held_uuids(service, pod)
        _check_nodes(cluster.backend, uuids, dev_dir, live)
        before = _node_state(stack, pod, dev_dir)
        fenced_before = FENCED_WRITES.total()
        t0 = time.perf_counter()
        resume.set()
        thread.join(60.0)
        fenced_ms = (time.perf_counter() - t0) * 1e3
    finally:
        resume.set()
        old._client_factory = factory
        leases.partitioned = False
    status, body, _, headers = answer["got"]
    if status != 503 or "fenced" not in body or headers.get("Retry-After") != "1":
        raise RuntimeError(f"the stale owner's add: {status} {body!r} {headers}")
    after = _node_state(stack, pod, dev_dir)
    if after != before or FENCED_WRITES.total() != fenced_before + 1:
        raise RuntimeError(f"the fenced add changed the node: {before} -> {after}")
    if service.ledger.epoch() != fresh_epoch:
        raise RuntimeError(f"the worker's epoch {service.ledger.epoch()}, the new owner's "
                           f"{fresh_epoch}")
    free = cluster.free_gpu_count()
    stack.acquire()
    remove_ms = _remove_one(stack, pod, uuids, dev_dir, base=stack.bases[1 - owner])
    _released(cluster, pod, free + 1)
    return {"stale_epoch": stale_epoch, "fresh_epoch": fresh_epoch, "takeover_ms": takeover_ms,
            "fenced_ms": fenced_ms, "fenced": body.strip(), "new_add_ms": new_add_ms,
            "remove_ms": remove_ms, "ledger_epoch": service.ledger.epoch()}


def shard_pool_check(device="cuda", *, dev_dir: str | None = None, ns_pid: int | None = None,
                     cgroup_dirs=(), identity: str = "nvml", repeats: int = 3,
                     ledger_root: str | None = None, on_pooled=None) -> dict:
    """Sharded masters, their epochs, the batch's owner routing and the warm
    pool through the master over HTTP and gRPC (``_MasterStack``), the
    worker with a ledger in a new directory under `ledger_root` (by default
    a temporary one), the cluster's ``FakeKubeClient`` as the API. Without
    grpcio it raises ``ModuleNotFoundError`` naming grpcio.

    (a) ``_pool_flows``: two replicas on their renew loops at the default
    lease (SHARD_LEASE_DURATION_S) and renew interval, as ``master/main.py``
    runs them with shard_count 2; the node's owner must stamp its epoch into
    the worker's ledger; the worker with a warm pool of 1 at the default
    backoff: `repeats` warm adds of 1 (a hit each, the remove, the refill),
    then the pool drained and `repeats` cold adds (a miss each);
    on_pooled(uuids, dev_dir) runs while the first pooled GPU is mounted.
    (b) ``_two_replicas``: the same replicas' 307 and proxied batch. (c)
    ``_stale_owner``: leases of SHARD_POOL_LEASE_S, every pass by hand (no
    renew loop), the takeover and the fenced add. Each stack's start is
    timed (its workers, its replicas, their first leases).

    On the card (device="cuda") the flows run on the live
    ``NvidiaDeviceBackend`` (`dev_dir`, `ns_pid`, `cgroup_dirs`, `identity`
    as in ``mount_check``), and without CAP_MKNOD it raises; on the CPU on a
    fake host of 2 GPUs. Runs on the card unless the caller passes
    device="cpu".

    Returns {"cap_mknod", "live" or "fake": {"start_ms", "pool", "replicas", "stale"},
    the other None}; ms on the host clock."""
    device = resolve_device(device)
    report = {"cap_mknod": has_cap_mknod(), "live": None, "fake": None}
    if device.type == "cuda" and not report["cap_mknod"]:
        raise RuntimeError("shard_pool_check on the card needs CAP_MKNOD: its adds and removes "
                           "must be the card's own GPU's")
    root = tempfile.mkdtemp(prefix="shard-pool-check-")
    ledgers = tempfile.mkdtemp(prefix="shard-pool-ledgers-", dir=ledger_root)
    flows: dict = {"start_ms": {}}
    try:
        def stack(name: str, shard_cfg: dict, renew_loop: bool, **knobs) -> _MasterStack:
            t0 = time.perf_counter()
            cfg = Config(auth_mode="token", auth_token=secrets.token_hex(16),
                         ledger_dir=os.path.join(ledgers, name), **knobs)
            if device.type == "cuda":
                cluster = FakeCluster(NvidiaDeviceBackend(
                    "/dev", identity=make_identity(identity)), cfg=cfg)
                target, dirs = _live_target(os.path.join(root, name), dev_dir, cgroup_dirs)
                made = _MasterStack(cluster, {cluster.node_name: target}, ns_pid, dirs,
                                    replicas=2, shard_cfg=shard_cfg, renew_loop=renew_loop)
            else:
                cluster = FakeCluster.with_fake_gpus(os.path.join(root, name), 2, cfg=cfg)
                target = os.path.join(root, f"{name}-tenant-dev")
                os.makedirs(target)
                made = _MasterStack(cluster, {cluster.node_name: target}, replicas=2,
                                    shard_cfg=shard_cfg, renew_loop=renew_loop)
            flows["start_ms"][name] = (time.perf_counter() - t0) * 1e3
            return made

        live = device.type == "cuda"
        # node_name "": the pool warms the cluster's node only, whatever
        # NODE_NAME the environment holds
        with stack("pool", {}, True, warm_pool_size=1, node_name="") as s:
            try:
                flows["pool"] = _pool_flows(s, s.dev_dirs[s.cluster.node_name], repeats, live,
                                            on_pooled)
            finally:
                s.services[s.cluster.node_name].pool.stop()
        with stack("replicas", {}, True) as s:
            flows["replicas"] = _two_replicas(s, s.dev_dirs[s.cluster.node_name], repeats, live)
        with stack("stale", {"shard_lease_duration_s": SHARD_POOL_LEASE_S}, False) as s:
            flows["stale"] = _stale_owner(s, s.dev_dirs[s.cluster.node_name], live)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(ledgers, ignore_errors=True)
    report["live" if device.type == "cuda" else "fake"] = flows
    if failpoints.active():
        raise RuntimeError(f"failpoints left armed: {failpoints.active()}")
    return report


# --- the fleet planes: telemetry, SLOs, tenants and the trace assembly ---

#: the SLO windows of fleet_check: short enough that the collection before
#: the adds falls out of them by the final pass, so the burn rates judge the
#: check's own adds and not the process's earlier mounts
FLEET_SLO_WINDOW_S = 1.0
#: the read routes of the master and of the worker's ops port: every one
#: answers 401 without a token
MASTER_READ_ROUTES = ("/metrics", "/fleet", "/slo", "/tenants", "/audit", "/timeline",
                      "/apihealth", "/shards")
OPS_READ_ROUTES = ("/metrics", "/telemetry", "/audit", "/timeline", "/apihealth")
#: the fleet check's times are the host's
_HOST = torch.device("cpu")


class _StaticWorkers:
    """A registry of fixed node -> worker IP, for a collector of its own."""

    def __init__(self, nodes: dict[str, str]):
        self.nodes = dict(nodes)

    def registry_snapshot(self) -> dict[str, str]:
        return dict(self.nodes)


def _expected_verdicts(before: dict, after: dict, cfg) -> dict[str, bool]:
    """The breach verdicts of the mount objectives over the check's own
    adds, from two rollups: the share of mounts within 50 ms (the latency
    objective's bucket) and of successes, each against its budget at
    SLO_BURN_THRESHOLD; an objective with no traffic in the window cannot
    breach."""

    def delta(key: str) -> float:
        return float(after["fleet"][key]) - float(before["fleet"][key])

    def within(rollup: dict, bound: float) -> float:
        return sum(c for b, c in rollup["fleet"]["mount_buckets"] if abs(b - bound) < 1e-12)

    def breached(good: float, total: float, target: float) -> bool:
        return total > 0 and ((total - good) / total) / (1 - target) >= cfg.slo_burn_threshold

    total = delta("mount_count")
    return {"mount-latency-50ms": breached(within(after, 0.05) - within(before, 0.05), total,
                                           0.95),
            "mount-success": breached(delta("mount_success"),
                                      delta("mount_success") + delta("mount_error"), 0.999)}


def _fleet_flows(stack: _MasterStack, dev_dir: str, ops_base: str, read: str, repeats: int,
                 live: bool, on_mounted) -> dict:
    """(a) `repeats` HTTP adds and removes of one GPU, the first with
    on_mounted(uuids, dev_dir, ops_base, token) -> {"tenant", "steps", ...}
    while it is mounted; (c) the collection and every read with the read
    token, each checked. Returns the flows' numbers."""
    cluster, app = stack.cluster, stack.app
    node = cluster.node_name
    pod = cluster.add_target_pod("tenant-fleet")
    free = cluster.free_gpu_count()
    # the baseline: a pass of a collector of its own, into the engine as a
    # sample and not evaluated, so that the engine's breaches are the
    # check's adds' and not the process's earlier mounts'
    before = FleetCollector(app.registry, app.fleet.client_factory,
                            cfg=app.cfg).collect_once()
    app.slo.ingest(before)
    t_before = time.monotonic()
    events_before = len(cluster.kube.events_posted)
    records_before = len(audit.AUDIT.query(operation="slo.breach"))
    out: dict = {"add_ms": [], "remove_ms": [], "trace_ids": [], "tenant": None}
    for i in range(repeats):
        status, body, ms, tid = stack.traced("GET", _add_path(pod, 1))
        if (status, body) != (200, "Add GPU Success\n"):
            raise RuntimeError(f"GET {_add_path(pod, 1)}: {status} {body!r}")
        out["add_ms"].append(ms)
        out["trace_ids"].append(tid)
        uuids = stack.held(node, pod)
        _check_nodes(cluster.backend, uuids, dev_dir, live)
        if on_mounted is not None and i == 0:
            out["tenant"] = on_mounted(uuids, dev_dir, ops_base, stack.token)
        status, body, ms = stack.http("POST", _remove_path(pod), {"uuids": ",".join(uuids)})
        if (status, body) != (200, "Remove 1 GPUs Success\n"):
            raise RuntimeError(f"POST {_remove_path(pod)} {uuids}: {status} {body!r}")
        out["remove_ms"].append(ms)
        _released(cluster, pod, free)
    # the baseline's sample must be out of the SLO windows by the final pass
    time.sleep(max(0.0, FLEET_SLO_WINDOW_S - (time.monotonic() - t_before)))
    passes = [_timed(app.fleet.collect_once, _HOST) for _ in range(repeats)]
    out["collect_ms"] = [ms for _, ms in passes]

    def read_json(path: str):
        status, body, ms = stack.http("GET", path, token=read)
        if status != 200:
            raise RuntimeError(f"GET {path} with the read token: {status} {body!r}")
        return json.loads(body), ms

    # /slo first: the passes' samples are inside its windows, the baseline's
    # out of them
    slo, _ = read_json("/slo")
    verdicts = {o["name"]: o["breached"] for o in slo["objectives"]}
    expected = {name: False for name in verdicts}
    expected.update(_expected_verdicts(before, passes[-1][0], app.cfg))
    if verdicts != expected:
        raise RuntimeError(f"/slo's verdicts {verdicts} over the check's adds, expected "
                           f"{expected}")
    breaches = [m for _, m in cluster.kube.events_posted[events_before:]
                if m.get("reason") == "GPUSLOBurnRate"]
    records = len(audit.AUDIT.query(operation="slo.breach")) - records_before
    if len(breaches) != sum(verdicts.values()) or records != len(breaches):
        raise RuntimeError(f"{sum(verdicts.values())} breach(es) but {len(breaches)} "
                           f"GPUSLOBurnRate Event(s) and {records} audit record(s)")
    out["slo"] = {o["name"]: {k: o[k] for k in ("breached", "sli", "burn_fast")}
                  for o in slo["objectives"] if o["total_events"]}
    out["breach_messages"] = [m["message"] for m in breaches]
    fleet, _ = read_json("/fleet")
    entry = fleet["nodes"].get(node) or {}
    out["node"] = {k: entry.get(k) for k in ("mode", "breaker", "mount", "warm_pool")}
    adds = entry.get("mount", {}).get("count", 0) - before["nodes"][node]["mount"]["count"]
    if entry.get("mode") != "rpc" or adds != repeats:
        raise RuntimeError(f"/fleet's {node}: mode {entry.get('mode')!r}, {adds} mount(s) "
                           f"counted for the {repeats} add(s): {entry}")
    node_sum = sum(e["mount"]["count"] for e in fleet["nodes"].values())
    if fleet["fleet"]["mount_count"] != node_sum:
        raise RuntimeError(f"/fleet's total {fleet['fleet']['mount_count']} != the nodes' sum "
                           f"{node_sum}")
    exemplars = {ex["trace_id"] for ex in entry.get("exemplars", [])}
    out["exemplar"] = next((t for t in out["trace_ids"] if t in exemplars), None)
    if out["exemplar"] is None:
        raise RuntimeError(f"no exemplar of /fleet names an add's trace: {exemplars} against "
                           f"{out['trace_ids']}")
    status, metrics, _, headers = _http_with_headers(stack.base, "GET", "/metrics", read,
                                                     accept="application/openmetrics-text")
    ctype = next((v for k, v in headers.items() if k.lower() == "content-type"), "")
    if status != 200 or not ctype.startswith("application/openmetrics-text") \
            or f'trace_id="{out["exemplar"]}"' not in metrics:
        raise RuntimeError(f"/metrics as OpenMetrics ({status}, {ctype!r}) carries no exemplar "
                           f"of the adds")
    if out["tenant"] is not None:
        tenants, _ = read_json("/tenants")
        seen = tenants["tenants"].get(out["tenant"]["tenant"])
        if seen is None or seen["steps"] != out["tenant"]["steps"] or seen["node"] != node:
            raise RuntimeError(f"/tenants: {out['tenant']['tenant']} -> {seen}, the tenant took "
                               f"{out['tenant']['steps']} step(s) on {node}")
        out["tenant_seen"] = {k: seen[k] for k in ("node", "steps", "tokens_per_s")}
    tid = out["trace_ids"][0]
    remote = [s for s in assembly.REMOTE_SPANS.spans_for(tid) if s.get("node") == node]
    tree, _ = read_json(f"/trace/{tid}")
    phase_sum = sum(tree["phases"].values())
    if not tree["complete"] or not any(s["name"].startswith("worker.") for s in remote) \
            or abs(phase_sum - tree["wall_ms"]) > max(2.0, 0.05 * tree["wall_ms"]):
        raise RuntimeError(f"/trace/{tid}: complete {tree['complete']}, {len(remote)} span(s) "
                           f"federated from {node}, phases {tree['phases']} summing to "
                           f"{phase_sum:.3f} of {tree['wall_ms']:.3f} ms")
    out["trace"] = {"wall_ms": tree["wall_ms"], "phases": tree["phases"],
                    "dominant": tree["dominant"], "remote_spans": len(remote)}
    out["trace_ms"] = [read_json(f"/trace/{tid}")[1] for _ in range(repeats)]
    return out


def _fleet_scopes(stack: _MasterStack, ops_base: str, read: str, tid: str) -> dict:
    """The scopes: the read token refused on a mutation of each daemon, and
    every read of each refused without a token."""
    pod = Pod({"metadata": {"name": "scope-probe", "namespace": "default"}})
    out = {"read_on_add": stack.http("GET", _add_path(pod, 1), token=read)[0],
           "read_on_tenant_post": _http(ops_base, "POST", "/tenant-telemetry", read,
                                        payload={"schema": "tpumounter-tenant/1",
                                                 "tenant": "forged"})[0]}
    out["no_token"] = {f"master {p}": stack.http("GET", p, token=None)[0]
                       for p in MASTER_READ_ROUTES + (f"/trace/{tid}",)}
    out["no_token"].update({f"ops {p}": _http(ops_base, "GET", p, None)[0]
                            for p in OPS_READ_ROUTES + (f"/trace/{tid}",)})
    refused = {k: v for k, v in out["no_token"].items() if v != 401}
    if out["read_on_add"] != 401 or out["read_on_tenant_post"] != 401 or refused:
        raise RuntimeError(f"the read scope: the read token on /addgpu {out['read_on_add']} "
                           f"and on POST /tenant-telemetry {out['read_on_tenant_post']}, reads "
                           f"without a token answered {refused}")
    return out


def _fleet_costs(stack: _MasterStack, ops_base: str, repeats: int) -> dict:
    """One CollectTelemetry call and its payload's bytes, one POST
    /tenant-telemetry of a snapshot, one snapshot built, `repeats` times."""
    from gpumounter_tpu_torch.torchside.telemetry import TenantTelemetry
    address = stack.app.registry.worker_address(stack.cluster.node_name)
    out = {"call_ms": [], "payload_bytes": [], "post_ms": [], "snapshot_us": []}
    probe = TenantTelemetry("fleet-check/post-probe", pod="post-probe", token=stack.token)
    probe.record_step(0.01, tokens=1.0)
    for _ in range(repeats):
        # the collector's own client: a channel dialled for the call
        with stack.app.fleet.client_factory(address) as client:
            resp, ms = _timed(client.collect_telemetry, _HOST)
        out["call_ms"].append(ms)
        out["payload_bytes"].append(len(resp.telemetry.encode()))
        ok, ms = _timed(lambda: probe.publish(ops_base), _HOST)
        if not ok:
            raise RuntimeError(f"POST {ops_base}/tenant-telemetry with the mutate token failed")
        out["post_ms"].append(ms)
        _, ms = _timed(lambda: worker_telemetry_snapshot(cfg=stack.cfg), _HOST)
        out["snapshot_us"].append(ms * 1e3)
    return out


def _scrape_fallback(stack: _MasterStack, ops_port: int, repeats: int, rpc_count) -> dict:
    """(d) A second worker on the node's service without CollectTelemetry
    (``build_server(include_telemetry=False)``): a collector of its own
    must scrape its /metrics through the ops port with the read token, and
    find the same mount count as the RPC's rollup, no span and no tenant."""
    node, service = stack.cluster.node_name, stack.services[stack.cluster.node_name]
    legacy = build_server(service, address="127.0.0.1:0", include_telemetry=False)
    legacy.start()
    try:
        cfg = dataclasses.replace(stack.cfg, worker_port=legacy.bound_port,
                                  metrics_port=ops_port)
        spans = assembly.RemoteSpanStore()
        collector = FleetCollector(
            _StaticWorkers({node: "127.0.0.1"}),
            lambda address: WorkerClient(address, token=stack.token, cfg=cfg), cfg=cfg,
            span_store=spans)
        runs = [_timed(collector.collect_once, _HOST) for _ in range(repeats)]
    finally:
        legacy.stop(None).wait()
    entry = runs[-1][0]["nodes"][node]
    out = {"scrape_ms": [ms for _, ms in runs], "mode": entry.get("mode"),
           "mount_count": entry["mount"]["count"], "success": entry["mount"]["success"],
           "spans": len(spans), "tenants": entry.get("tenants"),
           "exemplars": entry.get("exemplars")}
    if (out["mode"], out["spans"], out["tenants"], out["exemplars"]) != ("scrape", 0, {}, []) \
            or out["mount_count"] != rpc_count or out["success"] < 1:
        raise RuntimeError(f"the scrape fallback: {out}, the RPC's rollup counted {rpc_count}")
    return out


def fleet_check(device="cuda", *, dev_dir: str | None = None, ns_pid: int | None = None,
                cgroup_dirs=(), identity: str = "nvml", repeats: int = 3,
                on_mounted=None) -> dict:
    """The fleet planes on a live hot-mount (``_MasterStack`` over HTTP and
    gRPC, the master with a read token beside its mutate token, the worker's
    ops port on a free port of 127.0.0.1). Without grpcio it raises
    ``ModuleNotFoundError`` naming grpcio.

    (a) `repeats` HTTP adds and removes of one GPU, each add's trace id
    kept; (b) on_mounted(uuids, dev_dir, ops_url, mutate_token) while the
    first is mounted: a tenant that publishes its steps to the ops port and
    returns {"tenant", "steps", ...}; (c) the collector's passes over the
    worker's CollectTelemetry, then /fleet (the node's mounts == the adds,
    the total == the nodes' sum), an exemplar naming an add (in /fleet and
    in /metrics as OpenMetrics), /tenants (the tenant's steps), /trace/<id>
    of the first add (complete, its worker spans federated through the
    remote store, its phases summing to its wall time within max(2 ms,
    5%)), /slo (each verdict the one its objective gives the check's own
    adds, FLEET_SLO_WINDOW_S windows; a breach with its GPUSLOBurnRate Event
    and audit record), all with the read token; the read token refused on
    /addgpu and POST /tenant-telemetry, every read refused without a token;
    the costs (one CollectTelemetry call and its bytes, one POST, one
    snapshot); (d) a second worker without CollectTelemetry, scraped.

    On the card (device="cuda") on the live ``NvidiaDeviceBackend`` (as
    ``master_check``: `dev_dir`, `ns_pid`, `cgroup_dirs`, `identity`), and
    without CAP_MKNOD it raises; on the CPU on a fake host of 2 GPUs. Runs
    on the card unless the caller passes device="cpu".

    Returns {"cap_mknod", "live" or "fake": the flows, the other None}; ms
    on the host clock."""
    device = resolve_device(device)
    report = {"cap_mknod": has_cap_mknod(), "live": None, "fake": None}
    live = device.type == "cuda"
    if live and not report["cap_mknod"]:
        raise RuntimeError("fleet_check on the card needs CAP_MKNOD: its adds and removes must "
                           "be the card's own GPU's")
    read = secrets.token_hex(16)
    cfg = Config(auth_mode="token", auth_token=secrets.token_hex(16), auth_read_token=read,
                 slo_fast_window_s=FLEET_SLO_WINDOW_S, slo_slow_window_s=FLEET_SLO_WINDOW_S,
                 fleet_scrape_interval_s=3600.0, node_name="")
    root = tempfile.mkdtemp(prefix="fleet-check-")
    try:
        if live:
            cluster = FakeCluster(NvidiaDeviceBackend("/dev", identity=make_identity(identity)),
                                  cfg=cfg)
            target, dirs = _live_target(root, dev_dir, cgroup_dirs)
            stack = _MasterStack(cluster, {cluster.node_name: target}, ns_pid, dirs)
        else:
            cluster = FakeCluster.with_fake_gpus(os.path.join(root, "fake"), 2, cfg=cfg)
            target = os.path.join(root, "fake-tenant-dev")
            os.makedirs(target)
            stack = _MasterStack(cluster, {cluster.node_name: target})
        ops = serve_ops(0, cfg, host="127.0.0.1")
        ops_base = f"http://127.0.0.1:{ops.server_address[1]}"
        try:
            with stack:
                flows = _fleet_flows(stack, target, ops_base, read, repeats, live, on_mounted)
                flows["scopes"] = _fleet_scopes(stack, ops_base, read, flows["trace_ids"][0])
                flows["costs"] = _fleet_costs(stack, ops_base, repeats)
                flows["scrape"] = _scrape_fallback(
                    stack, ops.server_address[1], repeats,
                    stack.app.fleet.payload()["nodes"][cluster.node_name]["mount"]["count"])
        finally:
            ops.shutdown()
            ops.server_close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    report["live" if live else "fake"] = flows
    return report


# --- health and recovery: the quarantine, the canary, an evacuation ---

#: the health check's knobs: a breaker that opens on two transport failures
#: and half-opens after HEALTH_BREAKER_RESET_S, two attempts a call, and the
#: plane's hysteresis at one strike to suspect, two to quarantined, two
#: canary passes to rehabilitating and two clean passes of probation
HEALTH_BREAKER_RESET_S = 0.5
HEALTH_KNOBS = dict(breaker_failure_threshold=2, breaker_reset_s=HEALTH_BREAKER_RESET_S,
                    rpc_max_attempts=2, rpc_retry_base_s=0.02, rpc_retry_cap_s=0.05,
                    health_suspect_strikes=1, health_quarantine_strikes=2,
                    health_clear_passes=1, health_rehab_canary_passes=2,
                    health_probation_passes=2, health_canary_interval_s=3600.0,
                    recovery_confirm_failures=2, recovery_grace_s=0.0,
                    recovery_probe_timeout_s=2.0, fleet_scrape_interval_s=3600.0)
#: a dead node's evacuation must land within this, from the kill
EVACUATION_DEADLINE_S = 30.0


class _ProbeRecorder:
    """A canary client that keeps what each ProbeGPU answered. While the
    probe runs, the canary pod's cgroup stand-in (`procs`) lists this
    process, which holds the GPU: the probe's holder scan counts it; the
    list is empty again before the canary's remove, whose force kills the
    pod's holders. With `vanish`, the GPU's node is first deleted from the
    target's /dev (between the add and the probe, as a runtime that lost
    it)."""

    def __init__(self, inner, dev_dir: str, backend, seen: list, vanish: bool, procs: str):
        self.inner, self.dev_dir, self.backend = inner, dev_dir, backend
        self.seen, self.vanish, self.procs = seen, vanish, procs

    def __enter__(self):
        self.inner.__enter__()
        return self

    def __exit__(self, *exc):
        return self.inner.__exit__(*exc)

    def add_gpu(self, *args, **kwargs):
        response = self.inner.add_gpu(*args, **kwargs)
        self.seen.append({"uuids": list(response.uuids), "nodes_in_dev": sorted(
            os.listdir(self.dev_dir))})
        return response

    def probe_gpu(self, *args, **kwargs):
        if self.vanish:
            for uuid in self.seen[-1]["uuids"]:
                os.unlink(os.path.join(self.dev_dir, self.backend.device_by_uuid(uuid).basename))
        with open(self.procs, "w") as f:
            f.write(f"{os.getpid()}\n")
        try:
            result, chips = self.inner.probe_gpu(*args, **kwargs)
        finally:
            open(self.procs, "w").close()
        self.seen[-1]["probe"] = {"result": result.name, "chips": [
            {"uuid": c.uuid, "healthy": c.healthy, "reason": c.reason,
             "holder_count": c.holder_count} for c in chips]}
        return result, chips

    def remove_gpu(self, *args, **kwargs):
        return self.inner.remove_gpu(*args, **kwargs)


def _canary_pass(stack: _MasterStack, dev_dir: str, vanish: bool) -> dict:
    """One ``CanaryProber.probe_once`` through the app's prober, its client
    wrapped by ``_ProbeRecorder``; the pass's ms (host clock), what the probe
    answered, the node's canary streaks after, and the GPU gone from the
    target's /dev and from the books."""
    app, cluster, node = stack.app, stack.cluster, stack.cluster.node_name
    from gpumounter_tpu_torch.health.plane import CANARY_FAILURES, CANARY_PROBES
    seen: list = []
    inner = app.canary.client_factory
    procs = os.path.join(stack.cgroup_dirs[0], "cgroup.procs")
    app.canary.client_factory = lambda address: _ProbeRecorder(
        inner(address), dev_dir, stack.services[node].collector.backend, seen, vanish, procs)
    probes, failures = CANARY_PROBES.total(), CANARY_FAILURES.total()
    try:
        t0 = time.perf_counter()
        driven = app.canary.probe_once()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        app.canary.client_factory = inner
    canary = app.health.payload()["nodes"][node]["canary"]
    pod = Pod(cluster.kube.get_pod(app.cfg.health_canary_namespace,
                                   f"{app.cfg.health_canary_pod_prefix}{node}"))
    if driven != 1 or len(seen) != 1 or "probe" not in seen[0]:
        raise RuntimeError(f"the canary pass drove {driven} probe(s): {seen}")
    backend = stack.services[node].collector.backend
    left = [name for name in (backend.device_by_uuid(u).basename for u in seen[0]["uuids"])
            if os.path.exists(os.path.join(dev_dir, name))]
    if stack.held(node, pod) or _slave_pods(cluster, pod) or left:
        raise RuntimeError(f"the canary left {stack.held(node, pod)} held, slave pods "
                           f"{_slave_pods(cluster, pod)}, {left} in the target")
    return {"ms": ms, "probe": seen[0]["probe"], "mounted": seen[0]["nodes_in_dev"],
            "canary": canary, "probes": CANARY_PROBES.total() - probes,
            "failures": CANARY_FAILURES.total() - failures}


def _health_records(node: str) -> list[dict]:
    return [{"from": r["details"]["from_state"], "to": r["details"]["to_state"],
             "signals": r["details"]["signals"]}
            for r in flight.FLIGHT.snapshot() if r["kind"] == "health" and r["node"] == node]


def _manual_and_canary(stack: _MasterStack, dev_dir: str, read: str, before_canary) -> dict:
    """(a) and the first half of (b): the operator's quarantine, the pull's
    drain of the warm pool, a clean canary (this process holding the GPU
    while it is probed), a canary whose node vanished, the operator's
    release and the pool's refill."""
    from gpumounter_tpu_torch.allocator.pool import WARM_POOL_DRAINED
    app, node = stack.app, stack.cluster.node_name
    pool = stack.services[node].pool
    if not pool.wait_ready(node, 1, timeout_s=30.0):
        raise RuntimeError("the warm pool never filled")
    out: dict = {}
    status, body, out["quarantine_ms"] = stack.http(
        "POST", f"/health/quarantine/{node}",
        payload={"action": "quarantine", "reason": "health check"})
    pane = json.loads(body)["health"] if status == 200 else None
    if status != 200 or pane["state"] != "quarantined" or not pane["manual"]:
        raise RuntimeError(f"POST /health/quarantine/{node}: {status} {body}")
    drained = WARM_POOL_DRAINED.total()
    t0 = time.perf_counter()
    app.fleet.collect_once()
    out["pass_ms"] = (time.perf_counter() - t0) * 1e3
    out["drained"] = WARM_POOL_DRAINED.total() - drained
    if not pool.drained(node) or pool.ready_count(node) != 0 or out["drained"] != 1:
        raise RuntimeError(f"the pull did not drain the pool: drained {pool.drained(node)}, "
                           f"{pool.ready_count(node)} ready, {out['drained']} released")
    out["before_canary"] = before_canary() if before_canary is not None else None
    out["clean"] = _canary_pass(stack, dev_dir, vanish=False)
    chips = out["clean"]["probe"]["chips"]
    if out["clean"]["probe"]["result"] != "Success" or len(chips) != 1 \
            or not chips[0]["healthy"] or chips[0]["holder_count"] < 1 \
            or out["clean"]["canary"]["consecutive_ok"] != 1 or out["clean"]["failures"]:
        raise RuntimeError(f"the clean canary: {out['clean']}")
    out["vanished"] = _canary_pass(stack, dev_dir, vanish=True)
    chips = out["vanished"]["probe"]["chips"]
    if len(chips) != 1 or chips[0]["healthy"] \
            or "injected device node vanished" not in chips[0]["reason"] \
            or out["vanished"]["canary"]["consecutive_failures"] != 1 \
            or out["vanished"]["failures"] != 1:
        raise RuntimeError(f"the canary whose node vanished: {out['vanished']}")
    status, body, _ = stack.http("POST", f"/health/quarantine/{node}",
                                 payload={"action": "release"})
    if status != 200 or json.loads(body)["health"]["state"] != "healthy":
        raise RuntimeError(f"the release: {status} {body}")
    app.fleet.collect_once()  # the pull un-drains
    out["refill_ms"] = _until(lambda: pool.ready_count(node) == 1, 30.0,
                              "the refill after the release")
    status, body, _ = stack.http("GET", "/health/nodes", token=read)
    out["pane"] = json.loads(body)["nodes"][node] if status == 200 else None
    if out["pane"] is None or out["pane"]["state"] != "healthy":
        raise RuntimeError(f"/health/nodes after the release: {status} {body}")
    return out


def _scored_and_rehabilitated(stack: _MasterStack, dev_dir: str) -> dict:
    """The rest of (b): two transport failures of a real add open the mount
    path's breaker; the collector's passes score it (suspect, then
    quarantined, by the budget); after the breaker's reset two clean
    canaries, then passes of probation, bring the node back to healthy."""
    app, cluster, node = stack.app, stack.cluster, stack.cluster.node_name
    pod = cluster.add_target_pod("tenant-breaker")
    pool = stack.services[node].pool
    with failpoints.armed({"rpc.client.call": "2*unavailable(health check drop)"}):
        status, body, _ = stack.http("GET", _add_path(pod, 1))
    address = app.registry.worker_address(node)
    if status not in (500, 503) or app.registry.breaker.state(address) != "open":
        raise RuntimeError(f"the dropped add: {status} {body}, breaker "
                           f"{app.registry.breaker.state(address)}")
    states = []

    def collect() -> str:
        app.fleet.collect_once()
        states.append(app.health.payload()["nodes"][node]["state"])
        return states[-1]

    if (collect(), collect()) != ("suspect", "quarantined"):
        raise RuntimeError(f"the scorer's passes over the open breaker: {states}")
    time.sleep(HEALTH_BREAKER_RESET_S)
    canaries = []
    for _ in range(app.cfg.health_rehab_canary_passes):
        canaries.append(_canary_pass(stack, dev_dir, vanish=False))
        if not pool.drained(node):
            # the canary adopted the warm holder: its refill lands before the
            # next pass drains the pool (one GPU on the card: a refill still
            # in flight would book it under the next canary's add)
            _until(lambda: pool.ready_count(node) == 1, 30.0, "the refill after a canary")
        collect()
    if states[-1] != "rehabilitating":
        raise RuntimeError(f"after {len(canaries)} clean canaries: {states}")
    while states[-1] == "rehabilitating" and len(states) < 10:
        collect()
    if states[-1] != "healthy":
        raise RuntimeError(f"the probation: {states}")
    # no longer quarantined, the pull un-drained the pool: its refill lands
    # before the next add
    _until(lambda: pool.ready_count(node) == 1, 30.0, "the refill after the rehabilitation")
    return {"states": states, "canary_ms": [c["ms"] for c in canaries],
            "breaker": app.registry.breaker.state(address)}


def _worker_death(stack: _MasterStack, read: str, workdir: str, backend_cfg: dict) -> dict:
    """(c): the node's worker becomes a child process (``_MasterStack.spawn``
    with `backend_cfg`, its files in `workdir`); a GPU mounted through the
    master and that process, the node quarantined by hand; the process is
    killed with SIGKILL, its worker pod deleted and its Node NotReady in the
    API; recovery passes until the node is evacuated. The add's slave pod
    must be released, the evacuation listed by /recovery, and a release of
    the node refused."""
    app, cluster, node = stack.app, stack.cluster, stack.cluster.node_name
    t0 = time.perf_counter()
    child = stack.spawn(node, workdir, **backend_cfg)
    spawn_ms = (time.perf_counter() - t0) * 1e3
    pod = cluster.add_target_pod("tenant-dies")
    status, body, add_ms = stack.http("GET", _add_path(pod, 1))
    slaves = _slave_pods(cluster, pod)
    if status != 200 or len(slaves) != 1:
        raise RuntimeError(f"the add before the death: {status} {body}, slave pods {slaves}; "
                           f"the worker process's log: {child.log_tail()}")
    status, body, _ = stack.http("POST", f"/health/quarantine/{node}",
                                 payload={"action": "quarantine", "reason": "before death"})
    if status != 200:
        raise RuntimeError(f"the quarantine before the death: {status} {body}")
    if app.recovery.check_once()["evacuated"] or \
            app.recovery.payload()["nodes"][node]["status"] != "healthy":
        raise RuntimeError(f"the live node's recovery pass: {app.recovery.payload()}")
    t0 = time.perf_counter()
    stack.kill(node)
    if child.proc.returncode != -signal.SIGKILL:
        raise RuntimeError(f"the worker process's end: {child.proc.returncode}, not SIGKILL")
    passes = []
    deadline = time.monotonic() + EVACUATION_DEADLINE_S
    while time.monotonic() < deadline:
        passes.append(app.recovery.check_once())
        if node in passes[-1]["evacuated"]:
            break
        time.sleep(0.05)
    evacuation_ms = (time.perf_counter() - t0) * 1e3
    if node not in passes[-1]["evacuated"]:
        raise RuntimeError(f"{node} not evacuated within {EVACUATION_DEADLINE_S} s: "
                           f"{app.recovery.payload()}")
    left = [Pod(p).name for p in cluster.kube.list_pods(cluster.cfg.pool_namespace)
            if Pod(p).node_name == node]
    status, body, _ = stack.http("GET", "/recovery", token=read)
    listed = [e for e in json.loads(body)["evacuations"] if e["node"] == node] \
        if status == 200 else []
    if left or not listed or slaves[0] not in listed[-1]["released_bookings"]:
        raise RuntimeError(f"after the evacuation: pool pods {left} on {node}, /recovery "
                           f"{status} {body}")
    status, body, _ = stack.http("POST", f"/health/quarantine/{node}",
                                 payload={"action": "release"})
    if status != 409 or "evacuated" not in body:
        raise RuntimeError(f"the release of the evacuated node: {status} {body}")
    return {"spawn_ms": spawn_ms, "pid": child.proc.pid, "add_ms": add_ms,
            "evacuation_ms": evacuation_ms, "passes": len(passes),
            "released": listed[-1]["released_bookings"], "reason": listed[-1]["reason"],
            "release_refused": body.strip()}


def health_check(device="cuda", *, dev_dir: str | None = None, ns_pid: int | None = None,
                 identity: str = "nvml", ledger_root: str | None = None,
                 before_canary=None) -> dict:
    """Health and recovery on a live hot-mount (``_MasterStack`` over HTTP and
    gRPC, the master with a read token, the worker with a warm pool of 1 on
    its node and a ledger in a new directory under `ledger_root`, the
    cluster's ``FakeKubeClient`` as the API, HEALTH_KNOBS). Without grpcio it
    raises ``ModuleNotFoundError`` naming grpcio.

    (a) POST /health/quarantine/<node> with the mutate token; one collection
    pass carries ``quarantined`` to the worker, whose pool drains (ready 0,
    ``tpumounter_warm_pool_drained_total`` + 1); before_canary() (its result
    kept); then ``CanaryProber.probe_once``: the canary pod's add, ProbeGPU
    (healthy, holder_count >= 1: this process holds the GPU's node, and the
    canary pod's cgroup stand-in lists it while the GPU is probed) and the
    remove; again
    with the node deleted from the target's /dev between the add and the
    probe: unhealthy ("injected device node vanished"), a canary failure;
    then the operator's release and the pool's refill. (b) two dropped
    attempts of a real add open the breaker; the passes score it suspect,
    then quarantined; after the breaker's reset two clean canaries make it
    rehabilitating and probation healthy, every transition a flight record
    with its signals. (c) ``_worker_death``: the worker a child process,
    killed with SIGKILL (it needs openssl, for the stand-in API server's
    certificate).

    On the card (device="cuda") on the live ``NvidiaDeviceBackend`` mounting
    into `dev_dir` through the mount namespace of `ns_pid` (as
    ``mount_check``), and without CAP_MKNOD it raises; on the CPU on a fake
    host of 2 GPUs, whose nodes this process holds open. Runs on the card
    unless the caller passes device="cpu".

    Returns {"cap_mknod", "live" or "fake": {"start_ms", "manual", "scored",
    "death", "records"}, the other None}; ms on the host clock."""
    device = resolve_device(device)
    live = device.type == "cuda"
    report = {"cap_mknod": has_cap_mknod(), "live": None, "fake": None}
    if live and not report["cap_mknod"]:
        raise RuntimeError("health_check on the card needs CAP_MKNOD: its canary's adds and "
                           "removes must be the card's own GPU's")
    k8s_health.reset_all()
    read = secrets.token_hex(16)
    root = tempfile.mkdtemp(prefix="health-check-")
    ledgers = tempfile.mkdtemp(prefix="health-ledgers-", dir=ledger_root)
    held_open: list[int] = []
    try:
        t0 = time.perf_counter()
        cfg = Config(auth_mode="token", auth_token=secrets.token_hex(16), auth_read_token=read,
                     ledger_dir=ledgers, warm_pool_size=1, node_name="gpu-node-0",
                     **HEALTH_KNOBS)
        if live:
            cluster = FakeCluster(NvidiaDeviceBackend("/dev", identity=make_identity(identity)),
                                  cfg=cfg, node_name=cfg.node_name)
        else:
            cluster = FakeCluster.with_fake_gpus(os.path.join(root, "fake"), 2, cfg=cfg)
            # this process holds the fake GPUs' nodes, as a tenant with CUDA
            # open holds the card's
            held_open = [os.open(d.device_path, os.O_RDONLY)
                         for d in cluster.backend.list_devices()]
        # the pods' cgroup: a stand-in, which lists this process only while a
        # canary's GPU is probed (``_ProbeRecorder``)
        target, cgroup_dirs = _live_target(root, dev_dir, ())
        cluster.add_target_pod(f"{cfg.health_canary_pod_prefix}{cluster.node_name}",
                               namespace=cfg.health_canary_namespace)
        with _MasterStack(cluster, {cluster.node_name: target}, ns_pid if live else None,
                          cgroup_dirs) as stack:
            try:
                flows = {"start_ms": (time.perf_counter() - t0) * 1e3}
                stack.app.canary.start()  # canary_active; its loop's period is an hour
                flows["manual"] = _manual_and_canary(stack, target, read, before_canary)
                flows["scored"] = _scored_and_rehabilitated(stack, target)
                flows["records"] = _health_records(cluster.node_name)
                flows["death"] = _worker_death(
                    stack, read, root,
                    {"gpu_identity_source": identity} if live
                    else {"fake_device_dir": cluster.backend.root})
            finally:
                stack.services[cluster.node_name].pool.stop()
    finally:
        for fd in held_open:
            os.close(fd)
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(ledgers, ignore_errors=True)
        k8s_health.reset_all()
    report["live" if live else "fake"] = flows
    if failpoints.active():
        raise RuntimeError(f"failpoints left armed: {failpoints.active()}")
    return report


# --- the elastic controller and the live migration ---

#: the reconciler's and the machine's knobs of the check: no resync while it
#: drives the passes, the tenants' acks waited for long enough for a child
#: process's start on the card (its imports alone take seconds)
ELASTIC_MIGRATE_KNOBS = dict(elastic_resync_interval_s=3600.0, elastic_backoff_base_s=0.05,
                             elastic_backoff_cap_s=0.2, elastic_min_reconcile_interval_s=0.0,
                             migrate_quiesce_timeout_s=300.0,
                             migrate_checkpoint_timeout_s=300.0,
                             migrate_resume_timeout_s=300.0, migrate_poll_interval_s=0.02,
                             rpc_retry_base_s=0.02, rpc_retry_cap_s=0.05)
#: the rollback's acks: no tenant answers them, and the machine goes on
ROLLBACK_ACK_TIMEOUT_S = 0.3
#: a tenant's model and tokens on the CPU (the card's come from the caller)
MIGRATE_TENANT_CPU = dict(model=dict(vocab=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
                                     max_len=32, rope=True), tokens=[2, 32])
#: a tenant's deadline, from its start to its report
MIGRATE_TENANT_TIMEOUT_S = 600.0


class _MigrateTenant:
    """One end of the move (``testing/migrate_tenant.py``): a thread over the
    in-process API on the CPU, or on the card a process with
    CUDA_VISIBLE_DEVICES set to the GPU, over the stand-in API (`api`), its
    stderr in `log_path`."""

    def __init__(self, spec: dict, kube=None, api: dict | None = None, uuid: str = "",
                 log_path: str = ""):
        from gpumounter_tpu_torch.testing import migrate_tenant
        self.ready, self.ended = threading.Event(), threading.Event()
        self.report: dict | None = None
        self.error: str | None = None
        self.proc = None
        if api is None:
            def body():
                try:
                    self.report = migrate_tenant.run(
                        kube, {**spec, "on_ready": lambda r: self.ready.set()}, "cpu")
                except Exception as exc:  # noqa: BLE001 — handed to result()
                    self.error = f"{type(exc).__name__}: {exc}"
                finally:
                    self.ended.set()

            threading.Thread(target=body, name=f"tenant-{spec['role']}", daemon=True).start()
            return
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = {**os.environ, "CUDA_VISIBLE_DEVICES": uuid, "PYTHONPATH": os.pathsep.join(
            p for p in (repo, os.environ.get("PYTHONPATH", "")) if p)}
        self.log_path = log_path
        self._log = open(log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "gpumounter_tpu_torch.testing.migrate_tenant",
             json.dumps({**spec, "api": api})], cwd=repo, env=env, stdin=subprocess.DEVNULL,
            stdout=subprocess.PIPE, stderr=self._log, text=True)
        threading.Thread(target=self._read, name=f"tenant-{spec['role']}-out",
                         daemon=True).start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            if line.startswith("{"):
                msg = json.loads(line)
                if "ready" in msg:
                    self.ready.set()
                elif "report" in msg:
                    self.report = msg["report"]
        if self.proc.wait() != 0 or self.report is None:
            self._log.flush()
            with open(self.log_path, errors="replace") as f:
                self.error = f"exit {self.proc.returncode}: {f.read()[-3000:]}"
        self._log.close()
        self.ended.set()

    def wait_ready(self, timeout_s: float, what: str) -> None:
        deadline = time.monotonic() + timeout_s
        while not self.ready.wait(0.05):
            if self.ended.is_set() or time.monotonic() > deadline:
                raise RuntimeError(f"the {what} never watched its pod: {self.error}")

    def result(self, timeout_s: float, what: str) -> dict:
        if not self.ended.wait(timeout_s) or self.error is not None:
            self.stop()
            raise RuntimeError(f"the {what}: {self.error or 'no report in time'}")
        return self.report

    def stop(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def _intent_and_heal(stack: _MasterStack, dev_dir: str, pod) -> dict:
    """(a) PUT /intents of 1 GPU for `pod`, a pass of the reconciler's loop
    grows it (the slice coordinator's add), GET /intents shows it converged
    and ProbeGPU healthy; the GPU's node deleted from the target's /dev,
    ProbeGPU unhealthy, and the next pass heals: force-remove, the grow
    again (the only free GPU is the same, healthy at the host), the
    chip-replaced marker at generation 1, the ``elastic.heal`` record, the
    Event, one more ``tpumounter_chips_healed_total``; a
    ``torchside.watch_chip_replacements`` watcher on the pod fires once."""
    from gpumounter_tpu_torch.elastic.intents import ANNOT_REPLACED
    from gpumounter_tpu_torch.elastic.reconciler import CHIPS_HEALED, REPLACED_REASON
    from gpumounter_tpu_torch.torchside.heal import watch_chip_replacements
    app, cluster, node = stack.app, stack.cluster, stack.cluster.node_name
    path, key = f"/intents/{pod.namespace}/{pod.name}", f"{pod.namespace}/{pod.name}"
    status, body, put_ms = stack.http("PUT", path, payload={"desiredChips": 1, "minChips": 1})
    if status != 200 or json.loads(body)["desiredChips"] != 1:
        raise RuntimeError(f"PUT {path}: {status} {body}")
    t0 = time.perf_counter()
    app.elastic._process(key)
    grow_ms = (time.perf_counter() - t0) * 1e3
    status, body, _ = stack.http("GET", path)
    grown = json.loads(body).get("status", {}) if status == 200 else {}
    uuids = stack.held(node, pod)
    if grown.get("phase") != "converged" or grown.get("actual") != 1 or len(uuids) != 1:
        raise RuntimeError(f"the grow: GET {path} {status} {body}, held {uuids}")
    uuid = uuids[0]

    def probe() -> dict:
        with stack.client(node) as client:
            result, chips = client.probe_gpu(pod.name, pod.namespace)
        if result.name != "Success" or len(chips) != 1:
            raise RuntimeError(f"ProbeGPU of {key}: {result.name} {chips}")
        return {"uuid": chips[0].uuid, "healthy": chips[0].healthy, "reason": chips[0].reason}

    before = probe()
    fired: list[dict] = []
    stop = threading.Event()
    watcher = threading.Thread(target=watch_chip_replacements,
                               args=(cluster.kube, pod.namespace, pod.name, fired.append),
                               kwargs=dict(stop=stop, watch_timeout_s=1.0), daemon=True)
    watcher.start()
    try:
        basename = stack.services[node].collector.backend.device_by_uuid(uuid).basename
        os.unlink(os.path.join(dev_dir, basename))
        vanished = probe()
        if not before["healthy"] or vanished["healthy"] \
                or "injected device node vanished" not in vanished["reason"]:
            raise RuntimeError(f"ProbeGPU before {before}, after the node's deletion {vanished}")
        healed0, events0 = CHIPS_HEALED.total(), len(cluster.kube.events_posted)
        t0 = time.perf_counter()
        app.elastic._process(key)
        heal_ms = (time.perf_counter() - t0) * 1e3
        outcome = app.elastic.status_for(pod.namespace, pod.name) or {}
        marker = json.loads(Pod(cluster.kube.get_pod(pod.namespace, pod.name))
                            .annotations.get(ANNOT_REPLACED, "{}"))
        records = [r for r in audit.AUDIT.snapshot()
                   if r["operation"] == "elastic.heal" and r["pod"] == pod.name]
        events = [m for _, m in cluster.kube.events_posted[events0:]
                  if m.get("reason") == REPLACED_REASON]
        after = probe()
        if outcome.get("phase") != "converged" or outcome.get("healed") != 1 \
                or outcome.get("removed_dead") != [uuid] or outcome.get("added") != [uuid] \
                or marker.get("generation") != 1 or not marker.get("trace_id") \
                or len(records) != 1 or len(events) != 1 \
                or CHIPS_HEALED.total() - healed0 != 1 or not after["healthy"] \
                or not os.path.lexists(os.path.join(dev_dir, basename)):
            raise RuntimeError(f"the heal: outcome {outcome}, marker {marker}, records "
                               f"{records}, events {events}, probe {after}")
        watch_ms = _until(lambda: len(fired) >= 1, 10.0, "the heal watcher")
        if len(fired) != 1 or fired[0]["generation"] != 1:
            raise RuntimeError(f"the heal watcher fired {fired}")
    finally:
        stop.set()
        watcher.join(timeout=5.0)
    return {"uuid": uuid, "put_ms": put_ms, "grow_ms": grow_ms, "heal_ms": heal_ms,
            "vanished": vanished, "outcome": outcome, "marker": marker,
            "record": records[0], "event": events[0]["message"], "watcher_ms": watch_ms}


def _live_migration(stack: _MasterStack, src, dst, uuid: str, pack_dir: str, tenant: dict,
                    api: dict | None, workdir: str) -> dict:
    """(b) A tenant on each end (``_MigrateTenant``): the source's forward,
    then POST /migrate with the checkpoint; the source packs on the
    quiesce, saves on the checkpoint, acks each; the drain removes the GPU
    from the source, the remount mounts it into the destination, whose
    tenant restores on the resume, acks and runs the same forward: its
    logits' sha256 must be the source's. The journal ends succeeded after
    verify, the intent is on the destination, its lock is cleared, and
    /migrations/<mid> and /trace/<id> show every phase under the /migrate
    edge's trace."""
    from gpumounter_tpu_torch.migrate.journal import ANNOT_LOCK
    from gpumounter_tpu_torch.migrate.orchestrator import MIGRATIONS_TOTAL
    app, cluster, node = stack.app, stack.cluster, stack.cluster.node_name
    kube = cluster.kube
    specs = {role: {"role": role, "namespace": pod.namespace, "pod": pod.name,
                    "pack_dir": pack_dir, "seed": 0, "timeout_s": MIGRATE_TENANT_TIMEOUT_S,
                    **tenant}
             for role, pod in (("source", src), ("destination", dst))}
    t0 = time.perf_counter()
    tenants = {role: _MigrateTenant(spec, kube=kube, api=api, uuid=uuid,
                                    log_path=os.path.join(workdir, f"tenant-{role}.log"))
               for role, spec in specs.items()}
    try:
        for role, t in tenants.items():
            t.wait_ready(MIGRATE_TENANT_TIMEOUT_S, f"{role}'s tenant")
        ready_ms = (time.perf_counter() - t0) * 1e3
        succeeded0 = MIGRATIONS_TOTAL.get(phase="verify", outcome="succeeded")
        status, body, begin_ms, tid = stack.traced("POST", "/migrate", payload={
            "source": {"namespace": src.namespace, "pod": src.name},
            "destination": {"namespace": dst.namespace, "pod": dst.name}, "checkpoint": True})
        if status != 200:
            raise RuntimeError(f"POST /migrate: {status} {body}")
        mid = json.loads(body)["id"]
        journal = app.migrations.wait(mid, timeout_s=MIGRATE_TENANT_TIMEOUT_S)
        reports = {role: t.result(60.0, f"{role}'s tenant") for role, t in tenants.items()}
    finally:
        for t in tenants.values():
            t.stop()
    status, body, _ = stack.http("GET", f"/migrations/{mid}")
    listed = json.loads(body) if status == 200 else {}
    src_annotations = Pod(kube.get_pod(src.namespace, src.name)).annotations
    dst_annotations = Pod(kube.get_pod(dst.namespace, dst.name)).annotations
    status_src, _, _ = stack.http("GET", f"/intents/{src.namespace}/{src.name}")
    status_dst, body_dst, _ = stack.http("GET", f"/intents/{dst.namespace}/{dst.name}")
    trace_status, trace_body, _ = stack.http("GET", f"/trace/{journal['trace_id']}")
    spans = sorted({s["name"] for s in json.loads(trace_body).get("spans", [])}) \
        if trace_status == 200 else []
    phases = ["quiesce", "checkpoint", "drain", "remount", "resume", "verify"]
    source, dest = reports["source"], reports["destination"]
    if journal.get("outcome") != "succeeded" or listed.get("outcome") != "succeeded" \
            or journal["trace_id"] != tid or journal["chips"] != [uuid] \
            or journal["dest_chips"] != [uuid] or not journal["quiesced"] \
            or not journal["checkpointed"] or not journal["resumed"] \
            or stack.held(node, src) or stack.held(node, dst) != [uuid] \
            or status_src != 404 or status_dst != 200 \
            or json.loads(body_dst)["desiredChips"] != 1 or ANNOT_LOCK in dst_annotations \
            or json.loads(src_annotations["tpumounter.io/migration-phase"])["phase"] != "done" \
            or MIGRATIONS_TOTAL.get(phase="verify", outcome="succeeded") - succeeded0 != 1 \
            or not {f"migrate.{p}" for p in phases} | {"http.migrate_start"} <= set(spans):
        raise RuntimeError(f"the migration: journal {journal}, /migrations/{mid} {listed}, "
                           f"intents {status_src} {status_dst}, lock "
                           f"{dst_annotations.get(ANNOT_LOCK)}, spans {spans}")
    if source["signals"] != ["quiesce", "checkpoint"] or dest["signals"] != ["resume"] \
            or not dest["checkpointed"] or dest["chips"] != [uuid] \
            or source["trace_id"] != tid or dest["sha256"] != source["sha256"] \
            or not (source["finite"] and dest["finite"]):
        raise RuntimeError(f"the tenants: source {source}, destination {dest}")
    return {"id": mid, "trace_id": tid, "begin_ms": begin_ms, "tenants_ready_ms": ready_ms,
            "phases_s": journal["phase_durations_s"], "downtime_s": journal["downtime_s"],
            "spans": spans, "source": source, "destination": dest,
            "launches": source["launches"] + dest["launches"]}


def _rollback(stack: _MasterStack, src, dst, uuid: str, dev_dir: str) -> dict:
    """(c) ``migrate.phase.verify`` armed to fail, the GPU migrated back from
    `src` (which holds the intent now) to `dst`, no tenant (the acks time
    out in ROLLBACK_ACK_TIMEOUT_S): the machine rolls back, the GPU is in
    `src` again, the journal ends rolled-back with its Event, and the books,
    the ledger and the mounts agree."""
    from gpumounter_tpu_torch.migrate.orchestrator import ROLLED_BACK_REASON
    app, kube = stack.app, stack.cluster.kube
    cfg = app.migrations.cfg
    app.migrations.cfg = dataclasses.replace(
        cfg, migrate_quiesce_timeout_s=ROLLBACK_ACK_TIMEOUT_S,
        migrate_checkpoint_timeout_s=ROLLBACK_ACK_TIMEOUT_S,
        migrate_resume_timeout_s=ROLLBACK_ACK_TIMEOUT_S)
    events0 = len(kube.events_posted)
    try:
        with failpoints.armed({"migrate.phase.verify": "1*error(check rollback)"}):
            status, body, begin_ms = stack.http("POST", "/migrate", payload={
                "source": {"namespace": src.namespace, "pod": src.name},
                "destination": {"namespace": dst.namespace, "pod": dst.name}})
            if status != 200:
                raise RuntimeError(f"POST /migrate back: {status} {body}")
            mid = json.loads(body)["id"]
            t0 = time.perf_counter()
            journal = app.migrations.wait(mid, timeout_s=120.0)
            wait_ms = (time.perf_counter() - t0) * 1e3
    finally:
        app.migrations.cfg = cfg
    events = [m for _, m in kube.events_posted[events0:] if m.get("reason") == ROLLED_BACK_REASON]
    node = stack.cluster.node_name
    # the node's target holds the GPU for `src` alone: `dst`, which shares
    # the directory, has nothing booked or in the ledger
    books = {src.name: _books_mounts_ledger(stack, src, dev_dir), dst.name: sorted(
        stack.held(node, dst)) + sorted(stack.services[node].ledger.net_holdings().get(
            (dst.namespace, dst.name), set()))}
    if journal.get("outcome") != "rolled-back" or "check rollback" not in journal["error"] \
            or journal.get("rollback_healthy") != 1 or books != {src.name: [uuid], dst.name: []} \
            or len(events) != 1:
        raise RuntimeError(f"the rollback: journal {journal}, books {books}, events {events}")
    return {"id": mid, "begin_ms": begin_ms, "wait_ms": wait_ms, "error": journal["error"],
            "phases_s": journal["phase_durations_s"], "event": events[0]["message"],
            "books": books}


#: how long (d) waits for the run of its no-op plan to reach the history
DEFRAG_RUN_DEADLINE_S = 10.0


def _defrag_noop(stack: _MasterStack) -> dict:
    """(d) the defragmenter over HTTP on the stack's own node, after (c):
    GET /defrag (the gates open, nothing adopted), POST /defrag/plan over
    the node's real capacity view (a host of this stack's GPUs is never
    blocked for the default block of 4, so the plan is a no-op with no
    blocked host), POST /defrag/run of that plan, which reaches the history
    completed with 0 moves and stamps no ``capacity.recovered``. Raises on
    the first check that does not hold; the ms of each call on the host
    clock, and of the run's end from its POST."""
    node = stack.cluster.node_name
    status, body, get_ms = stack.http("GET", "/defrag")
    pane = json.loads(body) if status == 200 else {}
    gates = pane.get("gates") or {}
    if status != 200 or not gates.get("api_ok") or gates.get("slo_burning")             or pane.get("plan") is not None or pane.get("run") is not None:
        raise RuntimeError(f"(d) GET /defrag: {status} {body!r}")
    host = json.loads(stack.http("GET", "/capacity")[1])["nodes"][node]
    status, body, plan_ms = stack.http("POST", "/defrag/plan", payload={})
    plan = json.loads(body) if status == 200 else {}
    if status != 200 or plan.get("blocked_hosts") != [] or plan.get("moves") != []             or plan.get("fragmentation_before") != 0.0:
        raise RuntimeError(f"(d) POST /defrag/plan: {status} {body!r}")
    status, body, run_ms = stack.http("POST", "/defrag/run", payload={"plan_id": plan["id"]})
    if status != 200:
        raise RuntimeError(f"(d) POST /defrag/run: {status} {body!r}")
    t0 = time.perf_counter()
    run = None
    while run is None and time.perf_counter() - t0 < DEFRAG_RUN_DEADLINE_S:
        history = json.loads(stack.http("GET", "/defrag")[1])["history"]
        run = next((r for r in history if r["plan_id"] == plan["id"]), None)
        if run is None:
            time.sleep(0.005)
    done_ms = (time.perf_counter() - t0) * 1e3
    recovered = [r for r in audit.AUDIT.query(operation="capacity.recovered")
                 if (r.get("details") or {}).get("plan_id") == plan["id"]]
    records = [r["outcome"] for r in audit.AUDIT.query(operation="defrag.run")
               if (r.get("details") or {}).get("plan_id") == plan["id"]]
    if run is None or run["status"] != "completed" or run["moves"] != []             or [b["fragmentation_index"] for b in run["barriers"]] != [0.0, 0.0]             or recovered or records != ["completed: 0/0 move(s)"]:
        raise RuntimeError(f"(d) the run of {plan['id']}: {run}, defrag.run records {records}, "
                           f"capacity.recovered {recovered}")
    return {"get_ms": get_ms, "plan_ms": plan_ms, "run_ms": run_ms, "done_ms": done_ms,
            "plan_id": plan["id"], "status": run["status"], "moves": len(run["moves"]),
            "target_block": plan["target_block"],
            "host": {k: host[k] for k in ("total", "free", "held", "warm")}}


def elastic_migrate_check(device="cuda", *, dev_dir: str | None = None,
                          ns_pid: int | None = None, identity: str = "nvml",
                          ledger_root: str | None = None, tenant: dict | None = None) -> dict:
    """The elastic controller and the live migration on a live hot-mount
    (``_MasterStack`` over HTTP and gRPC, a ledger in a new directory under
    `ledger_root`, the cluster's ``FakeKubeClient`` as the API,
    ELASTIC_MIGRATE_KNOBS). Without grpcio it raises ``ModuleNotFoundError``
    naming grpcio.

    (a) ``_intent_and_heal``: an intent converged and then healed over
    ProbeGPU. (b) ``_live_migration`` to a second pod on the node, with a
    tenant at each end: on the card each is a process on the GPU
    (CUDA_VISIBLE_DEVICES, ``testing/migrate_tenant.py``) over a stand-in
    API server (it needs openssl, for its certificate), running `tenant`'s
    model ({"model": the ``TransformerConfig`` fields, "tokens": [B, L]})
    through flash_fwd; on the CPU a thread over the in-process API with
    MIGRATE_TENANT_CPU. The pack is saved in a new directory under
    `ledger_root`. (c) ``_rollback``: the GPU migrated back with verify
    failing. (d) ``_defrag_noop``: the defragmenter's routes on the node,
    a no-op plan and its run.

    On the card (device="cuda") on the live ``NvidiaDeviceBackend`` mounting
    into `dev_dir` through the mount namespace of `ns_pid` (as
    ``mount_check``), and without CAP_MKNOD it raises; on the CPU on a fake
    host of 1 GPU. Runs on the card unless the caller passes device="cpu".

    Returns {"cap_mknod", "live" or "fake": {"start_ms", "heal", "migration",
    "rollback", "defrag"}, the other None}; ms on the host clock."""
    device = resolve_device(device)
    live = device.type == "cuda"
    report = {"cap_mknod": has_cap_mknod(), "live": None, "fake": None}
    if live and not report["cap_mknod"]:
        raise RuntimeError("elastic_migrate_check on the card needs CAP_MKNOD: its heal and "
                           "its migration mount the card's own GPU")
    if live and tenant is None:
        raise ValueError("elastic_migrate_check on the card needs the tenants' model: "
                         "tenant={'model': ..., 'tokens': [B, L]}")
    k8s_health.reset_all()
    # the slice-feasibility objective gates (d), and its counters are the
    # process's: a master of its own starts them at zero, where an earlier
    # stack in this process (health_check's warm pool of 1: its one GPU warm,
    # admissible-after-defrag) left bad events this stack's engine would read
    # as its own from its first sample
    from gpumounter_tpu_torch.obs import capacity as capacity_obs
    capacity_obs.CAPACITY_SIZE_FEASIBLE.reset()
    capacity_obs.CAPACITY_SIZE_INFEASIBLE.reset()
    root = tempfile.mkdtemp(prefix="elastic-migrate-check-")
    ledgers = tempfile.mkdtemp(prefix="elastic-migrate-ledgers-", dir=ledger_root)
    packs = tempfile.mkdtemp(prefix="migrate-pack-", dir=ledger_root)
    api = None
    try:
        t0 = time.perf_counter()
        cfg = Config(auth_mode="token", auth_token=secrets.token_hex(16), ledger_dir=ledgers,
                     node_name="gpu-node-0", **ELASTIC_MIGRATE_KNOBS)
        if live:
            cluster = FakeCluster(NvidiaDeviceBackend("/dev", identity=make_identity(identity)),
                                  cfg=cfg, node_name=cfg.node_name)
        else:
            cluster = FakeCluster.with_fake_gpus(os.path.join(root, "fake"), 1, cfg=cfg)
        target, cgroup_dirs = _live_target(root, dev_dir, ())
        src = cluster.add_target_pod("tenant-intent")
        dst = cluster.add_target_pod("tenant-destination")
        if live:
            tls = selfsigned(root)
            if tls is None:
                raise RuntimeError("the tenants' stand-in API server needs openssl")
            server = FakeApiServer(cluster.kube, *tls).start()
            api = {"server": server, "port": server.port, "token": server.token,
                   "ca": tls[0]}
        with _MasterStack(cluster, {cluster.node_name: target}, ns_pid if live else None,
                          cgroup_dirs) as stack:
            flows = {"start_ms": (time.perf_counter() - t0) * 1e3}
            flows["heal"] = _intent_and_heal(stack, target, src)
            uuid = flows["heal"]["uuid"]
            flows["migration"] = _live_migration(
                stack, src, dst, uuid, packs, tenant or MIGRATE_TENANT_CPU,
                {k: v for k, v in api.items() if k != "server"} if api else None, root)
            flows["rollback"] = _rollback(stack, dst, src, uuid, target)
            flows["defrag"] = _defrag_noop(stack)
    finally:
        if api is not None:
            api["server"].stop()
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(ledgers, ignore_errors=True)
        shutil.rmtree(packs, ignore_errors=True)
        k8s_health.reset_all()
    report["live" if live else "fake"] = flows
    if failpoints.active():
        raise RuntimeError(f"failpoints left armed: {failpoints.active()}")
    return report



# --- the capacity plane and a metered share ---

#: the metered tenant's share: decode, weight 40 and 64 tokens, as the
#: chaos harness's (invariant 19); its re-grant's weight
SHARE = dict(namespace="default", pod="tenant-share", profile="decode", weight=40,
             rate_budget=64)
SHARE_REGRANT_WEIGHT = 60


def _capacity_read(stack: _MasterStack, read: str, path: str = "/capacity") -> dict:
    status, body, _ = stack.http("GET", path, token=read)
    if status != 200:
        raise RuntimeError(f"GET {path} with the read token: {status} {body!r}")
    return json.loads(body)


def _share_ledgers(stack: _MasterStack, uuid: str) -> dict:
    """Invariant 19's three ledgers for the tenant: the master's books, the
    worker ledger's share records and the policy engine's entries."""
    node, tenant = stack.cluster.node_name, f"{SHARE['namespace']}/{SHARE['pod']}"
    service = stack.services[node]
    dev = stack.cluster.backend.device_by_uuid(uuid)
    from gpumounter_tpu_torch.cgroup.policy import POLICY_ENGINE
    entries = POLICY_ENGINE.entries(tenant)
    key = ebpf.telemetry_key(dev.major, dev.minor)
    return {
        "books": stack.app.shares.books().get(tenant, {}),
        "ledger": service.ledger.share_holdings().get((SHARE["namespace"], SHARE["pod"]), {}),
        "engine": ({uuid: (ebpf.policy_weight(entries[key]), ebpf.policy_tokens(entries[key]))}
                   if key in entries else {}),
        "engine_keys": len(entries),
    }


def _throttle_parity(tenant: str, dev, weight: int) -> list[bool]:
    """Invariant 19's throttle walk (``testing.chaos.throttle_walk``) on the
    metered share: the program's decisions, which must be the engine's and
    deny past the budget. The engine's budget is put back after."""
    from gpumounter_tpu_torch.cgroup.policy import POLICY_ENGINE
    from gpumounter_tpu_torch.testing.chaos import THROTTLE_TOKENS, throttle_walk
    before = POLICY_ENGINE.entries(tenant)[ebpf.telemetry_key(dev.major, dev.minor)]
    decisions, left_engine, left_kernel = throttle_walk(tenant, dev, weight, THROTTLE_TOKENS)
    POLICY_ENGINE.refill(tenant, dev.major, dev.minor, ebpf.policy_tokens(before))
    if any(e != k for e, k in decisions) or any(k for _, k in decisions[THROTTLE_TOKENS:]) \
            or left_engine != left_kernel:
        raise RuntimeError(f"the throttle of a {THROTTLE_TOKENS}-token budget: (engine, device "
                           f"program) an access {decisions}, tokens left {left_engine} and "
                           f"{left_kernel}")
    return [k for _, k in decisions]


def _capacity_flows(stack: _MasterStack, dev_dir: str, read: str, live: bool,
                    on_mounted) -> dict:
    """(a)-(e) of ``capacity_share_check``; raises on the first check that
    does not hold."""
    from gpumounter_tpu_torch.obs import capacity as capacity_obs
    cluster, app = stack.cluster, stack.app
    node = cluster.node_name
    service = stack.services[node]
    total = len(cluster.backend.list_devices())
    out: dict = {}
    # (a) the inventory: a pass, then /capacity
    _, out["pass_ms"] = _timed(app.fleet.collect_once, _HOST)
    cap = _capacity_read(stack, read)
    host = cap["nodes"].get(node) or {}
    table = cap["feasibility"]
    multi = {k: v["tracked"] for k, v in table.items() if v["hosts_needed"] > 1}
    if (host.get("free"), host.get("held"), host.get("fenced"), host.get("total")) != \
            (total, 0, 0, total) or cap["fleet"]["fragmentation_index"] != 0.0 \
            or table["nvidia-h100-80gb-1"]["verdict"] != "admissible" \
            or not table["nvidia-h100-80gb-1"]["tracked"] or any(multi.values()):
        raise RuntimeError(f"(a) /capacity on a free node: {host}, fleet {cap['fleet']}, "
                           f"the one-GPU row {table['nvidia-h100-80gb-1']}, multi-host "
                           f"tracked {multi}")
    out["inventory"] = {"free": host["free_indices"], "total": total,
                        "verdicts": {k: v["verdict"] for k, v in table.items()},
                        "index": cap["fleet"]["fragmentation_index"]}
    snap_us = []
    for _ in range(5):
        _, ms = _timed(lambda: capacity_obs.node_capacity_snapshot(
            service.collector, pool=service.pool, cfg=service.cfg), _HOST)
        snap_us.append(ms * 1e3)
    out["snapshot_us"] = snap_us
    # (b) a metered share: booked, mounted with its policy, the ledgers
    uuid = cluster.backend.list_devices()[0].uuid
    pod = cluster.add_target_pod(SHARE["pod"], namespace=SHARE["namespace"])
    free = cluster.free_gpu_count()
    status, body, out["admit_ms"] = stack.http("POST", "/shares", payload={
        "namespace": SHARE["namespace"], "pod": SHARE["pod"], "profile": SHARE["profile"],
        "chips": 1, "weight": SHARE["weight"], "rate_budget": SHARE["rate_budget"],
        "inventory": {uuid: node}})
    if status != 200 or [s["chip_uuid"] for s in json.loads(body)["admitted"]] != [uuid]:
        raise RuntimeError(f"(b) POST /shares: {status} {body!r}")
    with stack.client(node) as client:
        response, out["add_ms"] = _timed(lambda: client.add_gpu(
            SHARE["pod"], SHARE["namespace"], 1, share_weight=SHARE["weight"],
            share_rate_budget=SHARE["rate_budget"]), _HOST)
    if response.add_gpu_result != AddGPUResult.Success or list(response.uuids) != [uuid]:
        raise RuntimeError(f"(b) AddGPU with share_weight {SHARE['weight']}: "
                           f"{AddGPUResult(response.add_gpu_result).name} {list(response.uuids)}")
    _check_nodes(cluster.backend, [uuid], dev_dir, live)
    ledgers = _share_ledgers(stack, uuid)
    want = {uuid: (SHARE["weight"], SHARE["rate_budget"])}
    if (ledgers["books"], ledgers["ledger"], ledgers["engine"]) != (want, want, want):
        raise RuntimeError(f"(b) invariant 19: books, ledger and engine disagree: {ledgers}")
    out["ledgers"] = {k: {u: list(v) for u, v in ledgers[k].items()}
                      for k in ("books", "ledger", "engine")}
    shares_pane = json.loads(stack.http("GET", "/shares", token=read)[1])
    if shares_pane["totals"] != {"shares": 1, "chips": 1, "shared_chips": 0}:
        raise RuntimeError(f"(b) /shares: {shares_pane['totals']}")
    dev = cluster.backend.device_by_uuid(uuid)
    out["throttle"] = _throttle_parity(f"{SHARE['namespace']}/{SHARE['pod']}", dev,
                                       SHARE["weight"])
    out["tenant"] = on_mounted([uuid], dev_dir) if on_mounted is not None else None
    # (c) the plane sees it, after a pass
    before = app.fleet.payload(max_age_s=None)["master"]
    _, out["held_pass_ms"] = _timed(app.fleet.collect_once, _HOST)
    cap = _capacity_read(stack, read)
    host, fleet = cap["nodes"][node], app.fleet.payload(max_age_s=None)
    section = fleet["nodes"][node].get("capacity") or {}
    slaves = {f"{cluster.cfg.pool_namespace}/{s.name}"
              for s in service.allocator.slave_pods_for(pod)}
    owners = set((section.get("held") or {}).values())
    feasible = fleet["master"]["slice_feasible"] - before["slice_feasible"]
    if (host["free"], host["held"]) != (total - 1, 1) or not owners or not owners <= slaves \
            or (total == 1 and cap["headroom"]["forecast"] != "exhausted") or feasible < 1:
        raise RuntimeError(f"(c) /capacity with the share mounted: {host}, held by {owners} "
                           f"(the pod's slave pods {slaves}), headroom "
                           f"{cap['headroom']['forecast']}, slice_feasible +{feasible}")
    out["held"] = {"owners": sorted(owners), "forecast": cap["headroom"]["forecast"],
                   "slice_feasible": feasible,
                   "slice_infeasible": fleet["master"]["slice_infeasible"]
                   - before["slice_infeasible"], "shares": cap.get("shares")}
    # (d) a second pod refused for capacity: the verdict in the audit trail
    # and on the timeline
    other = cluster.add_target_pod("tenant-refused")
    status, body, out["refused_ms"] = stack.http("GET", _add_path(other, total))
    rejections = [r for r in audit.AUDIT.query(operation="capacity.reject", limit=10)
                  if r["pod"] == other.name]
    status_t, body_t, _ = stack.http("GET", "/timeline?kind=audit&limit=50", token=read)
    on_timeline = any("capacity.reject" in r.get("summary", "") and other.name in
                      r.get("summary", "") for r in json.loads(body_t)["records"])
    if status != 500 or len(rejections) != 1 or \
            rejections[0]["details"].get("cause") != "exhaustion" or not on_timeline:
        raise RuntimeError(f"(d) the refused add: {status} {body!r}, its capacity.reject "
                           f"records {rejections}, on /timeline {on_timeline} ({status_t})")
    out["rejection"] = {"outcome": rejections[0]["outcome"],
                        "cause": rejections[0]["details"]["cause"]}
    # (e) a re-grant at another weight, as the reference makes one: the
    # master's books in place, the worker not reached (no route or RPC
    # carries a re-grant: POST /shares passes over a tenant's own GPUs);
    # then the forced remove and the release clear all three ledgers
    swaps = ebpf.PROGRAM_SWAPS.get()
    status, body, _ = stack.http("POST", "/shares", payload={
        "namespace": SHARE["namespace"], "pod": SHARE["pod"], "profile": SHARE["profile"],
        "chips": 1, "weight": SHARE_REGRANT_WEIGHT, "rate_budget": SHARE["rate_budget"],
        "inventory": {uuid: node}})
    if status != 409:
        raise RuntimeError(f"(e) POST /shares on the tenant's own GPU: {status} {body!r}")
    _, ms = _timed(lambda: app.shares.add(Share(
        namespace=SHARE["namespace"], pod=SHARE["pod"], chip_uuid=uuid, node=node,
        weight=SHARE_REGRANT_WEIGHT, rate_budget=SHARE["rate_budget"],
        profile=SHARE["profile"])), _HOST)
    out["regrant_us"] = ms * 1e3
    ledgers = _share_ledgers(stack, uuid)
    regranted = {uuid: (SHARE_REGRANT_WEIGHT, SHARE["rate_budget"])}
    if ebpf.PROGRAM_SWAPS.get() != swaps or (ledgers["books"], ledgers["ledger"],
                                             ledgers["engine"]) != (regranted, want, want) \
            or len(app.shares.payload()["shares"]) != 1:
        raise RuntimeError(f"(e) the re-grant: program swaps {swaps} -> "
                           f"{ebpf.PROGRAM_SWAPS.get()}, {ledgers}")
    out["regrant"] = {k: {u: list(v) for u, v in ledgers[k].items()}
                      for k in ("books", "ledger", "engine")}
    status, body, out["remove_ms"] = stack.http(
        "POST", f"/removegpu/namespace/{pod.namespace}/pod/{pod.name}/force/true",
        {"uuids": uuid})
    if (status, body) != (200, "Remove 1 GPUs Success\n"):
        raise RuntimeError(f"(e) the forced remove: {status} {body!r}")
    status, body, out["release_ms"] = stack.http(
        "DELETE", f"/shares/{SHARE['namespace']}/{SHARE['pod']}")
    if status != 200 or [s["chip_uuid"] for s in json.loads(body)["released"]] != [uuid]:
        raise RuntimeError(f"(e) DELETE /shares: {status} {body!r}")
    _released(cluster, pod, free)
    ledgers = _share_ledgers(stack, uuid)
    if (ledgers["books"], ledgers["ledger"], ledgers["engine"], ledgers["engine_keys"]) != \
            ({}, {}, {}, 0):
        raise RuntimeError(f"(e) the release left {ledgers}")
    app.fleet.collect_once()
    host = _capacity_read(stack, read)["nodes"][node]
    if (host["free"], host["held"]) != (total, 0):
        raise RuntimeError(f"(e) /capacity after the release: {host}")
    out["freed"] = host["free_indices"]
    return out


def capacity_share_check(device="cuda", *, dev_dir: str | None = None,
                         ns_pid: int | None = None, cgroup_dirs=(), identity: str = "nvml",
                         ledger_root: str | None = None, on_mounted=None) -> dict:
    """The capacity plane and a metered share on a live hot-mount
    (``_MasterStack`` over HTTP and gRPC, the master with a read token beside
    its mutate token, the worker with a ledger in a new directory under
    `ledger_root`, the cluster's ``FakeKubeClient`` as the API, the
    collector's passes by hand). Without grpcio it raises
    ``ModuleNotFoundError`` naming grpcio.

    (a) a pass, then /capacity: every GPU free, the one-GPU shape admissible
    and tracked, no multi-host shape tracked, the index 0; the snapshot's
    cost. (b) POST /shares books the decode tenant (SHARE: weight 40, budget
    64) on the first GPU; the worker's AddGPU with share_weight and
    share_rate_budget mounts it; the master's books, the ledger's share
    record and the policy engine's entry agree (invariant 19), /shares shows
    it, the throttle decides alike in the engine and the device program;
    on_mounted([uuid], dev_dir) runs while it is mounted (on the card a
    tenant process on the GPU). (c) after a pass /capacity reads the GPU
    held by the pod's slave pod, the headroom exhausted on a one-GPU host,
    the slice-feasibility counter advanced. (d) a second pod's /addgpu
    answers 500 with one ``capacity.reject`` of cause exhaustion, on
    /timeline too. (e) POST /shares on the tenant's own GPU answers 409 (the
    packer passes over it), and the re-grant at SHARE_REGRANT_WEIGHT
    (``ShareRegistry.add``, as the reference's) changes the books in place
    and nothing on the worker: the ledger and the engine keep the first
    weight, no program swap; the forced remove and DELETE /shares clear the
    three ledgers, and /capacity reads the GPU free again.

    On the card (device="cuda") on the live ``NvidiaDeviceBackend`` mounting
    into `dev_dir` through the mount namespace of `ns_pid` (as
    ``mount_check``), and without CAP_MKNOD it raises; on the CPU on a fake
    host of 1 GPU. Runs on the card unless the caller passes device="cpu".

    Returns {"cap_mknod", "live" or "fake": {"start_ms", and (a)-(e)'s
    numbers}, the other None}; ms on the host clock."""
    device = resolve_device(device)
    live = device.type == "cuda"
    report = {"cap_mknod": has_cap_mknod(), "live": None, "fake": None}
    if live and not report["cap_mknod"]:
        raise RuntimeError("capacity_share_check on the card needs CAP_MKNOD: its share is "
                           "the card's own GPU, mounted")
    k8s_health.reset_all()
    root = tempfile.mkdtemp(prefix="capacity-share-check-")
    ledgers = tempfile.mkdtemp(prefix="capacity-share-ledgers-", dir=ledger_root)
    read = secrets.token_hex(16)
    try:
        t0 = time.perf_counter()
        cfg = Config(auth_mode="token", auth_token=secrets.token_hex(16), auth_read_token=read,
                     ledger_dir=ledgers, node_name="gpu-node-0", fleet_scrape_interval_s=3600.0)
        if live:
            cluster = FakeCluster(NvidiaDeviceBackend("/dev", identity=make_identity(identity)),
                                  cfg=cfg, node_name=cfg.node_name)
        else:
            cluster = FakeCluster.with_fake_gpus(os.path.join(root, "fake"), 1, cfg=cfg)
        target, dirs = _live_target(root, dev_dir, cgroup_dirs)
        with _MasterStack(cluster, {cluster.node_name: target}, ns_pid if live else None,
                          dirs) as stack:
            flows = {"start_ms": (time.perf_counter() - t0) * 1e3}
            flows.update(_capacity_flows(stack, target, read, live, on_mounted))
    finally:
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(ledgers, ignore_errors=True)
        k8s_health.reset_all()
    report["live" if live else "fake"] = flows
    return report


# --- the autoscaler on a live hot-mount ---

#: the tenant's batch windows (rows of AUTOSCALE_ROW tokens), each of
#: AUTOSCALE_STEPS steps: more than the 32 token marks ``TenantTelemetry``
#: keeps, so that each window's published tokens/s is its own; the first is
#: the model's baseline (a first sighting derives no sample), so the fit has
#: four samples
AUTOSCALE_WINDOWS = (1, 1, 2, 4, 8)
AUTOSCALE_STEPS = 40
AUTOSCALE_ROW = 2048
#: the queue depth the tenant reports with every step (AUTOSCALE_QUEUE_GROW
#: is 32, so only the utilization decides between a grow and steady)
AUTOSCALE_QUEUE = 64.0
#: the CPU's stand-in tenant: a server on rate(b) = r_max * b / (b + b_half)
#: (tokens/s over tokens a step), its steps timed on a clock of its own, so
#: that the fit must find this curve again
AUTOSCALE_CPU_CURVE = {"r_max": 3.35e6, "b_half": 2048.0}
#: the fit held against the windows it was fitted on: r_max and b_half
#: within AUTOSCALE_REFIT_RTOL of a least squares of the windows' own
#: (batch, rate) pairs made here with numpy. How well the curve describes
#: them is reported, not gated: an H100 tenant's rate rises linearly while
#: each step costs the host's ≈ 2-3 ms of launches and flattens once the
#: forward costs more, a shape the curve cannot take, and the host's noise
#: moves each window's miss and the plateau's distance past the fastest
AUTOSCALE_REFIT_RTOL = 1e-6


def autoscale_tenant_cpu(uuids, dev_dir, url, token, collect,
                         tenant: str = "default/tenant-autoscale") -> dict:
    """The stand-in tenant of ``autoscale_check`` on the CPU: the windows of
    AUTOSCALE_WINDOWS, each step recorded on a clock of its own at the rate
    AUTOSCALE_CPU_CURVE gives its tokens, the snapshot published to `url`
    after each window and collect() called. Returns {"tenant", "steps",
    "windows": [{"B", "tokens_per_s", "published"}]}."""
    from gpumounter_tpu_torch.torchside.telemetry import TenantTelemetry
    now = [1000.0]
    namespace, pod = tenant.split("/", 1)
    tel = TenantTelemetry(tenant, namespace=namespace, pod=pod, token=token,
                          clock=lambda: now[0])
    r_max, b_half = AUTOSCALE_CPU_CURVE["r_max"], AUTOSCALE_CPU_CURVE["b_half"]
    windows = []
    for b in AUTOSCALE_WINDOWS:
        tokens = float(b * AUTOSCALE_ROW)
        for _ in range(AUTOSCALE_STEPS):
            duration = tokens / (r_max * tokens / (tokens + b_half))
            now[0] += duration
            tel.record_step(duration, tokens=tokens, queue_depth=AUTOSCALE_QUEUE)
        published = tel.publish(url)
        windows.append({"B": b, "tokens_per_s": tel.snapshot()["tokens_per_s"],
                        "published": published})
        collect()
    return {"tenant": tenant, "steps": AUTOSCALE_STEPS * len(AUTOSCALE_WINDOWS),
            "windows": windows}


def _expected_reasons(fit: dict, queue: float, cfg) -> list[str]:
    """The reference's rule for a tenant with a fit that may be acted on, one
    GPU held and none free or warm, over two passes: a grow signal holds for
    the hysteresis and then finds the fleet infeasible, a hold that restarts
    the streak; otherwise steady (the queue is over AUTOSCALE_QUEUE_SHRINK,
    so no shrink)."""
    util = float(fit["utilization"])
    if queue <= cfg.autoscale_queue_shrink and util <= cfg.autoscale_util_shrink:
        raise RuntimeError(f"a shrink signal at queue {queue}: the check wants a deep queue")
    if queue < cfg.autoscale_queue_grow or util < cfg.autoscale_util_grow:
        return ["steady", "steady"]
    reasons, streak = [], 0
    for _ in range(2):
        streak += 1
        reasons.append("hysteresis" if streak < cfg.autoscale_hysteresis else "infeasible")
        streak = 0 if reasons[-1] == "infeasible" else streak
    return reasons


def _refit(pairs: list[tuple[float, float]]) -> dict:
    """rate = r_max * b / (b + b_half) through numpy's least squares of 1/r
    on 1/b, apart from the model's code; a non-positive intercept gives the
    mean rate as the plateau, as the model's rule does."""
    inv_b, inv_r = (np.array([1.0 / v for v in col]) for col in zip(*pairs))
    slope, intercept = np.polyfit(inv_b, inv_r, 1)
    if intercept <= 1e-12:
        return {"r_max": float(np.mean([r for _, r in pairs])), "b_half": 0.0}
    return {"r_max": float(1.0 / intercept), "b_half": float(max(0.0, slope / intercept))}


def _fit_vs_windows(fit: dict, windows: list[dict]) -> dict:
    """The fit against the tenant's windows that made its samples (all but
    the first, the model's baseline): numpy's refit of their (batch, rate)
    pairs, which r_max and b_half must meet within AUTOSCALE_REFIT_RTOL (it
    raises otherwise); each window's rate, the fit's prediction at its batch
    and their relative gap; and r_max over the fastest rate."""
    from gpumounter_tpu_torch.autoscale.model import predict
    rows = []
    for w in windows[1:]:
        rate = float(w["tokens_per_s"])
        modelled = predict(fit, float(w["B"] * AUTOSCALE_ROW))
        rows.append({"B": w["B"], "rate": rate, "predicted": modelled,
                     "rel_err": abs(modelled - rate) / rate})
    refit = _refit([(float(r["B"] * AUTOSCALE_ROW), r["rate"]) for r in rows])
    refit_err = max(abs(float(fit[k]) - refit[k]) / max(abs(refit[k]), 1e-9)
                    for k in ("r_max", "b_half"))
    if refit_err > AUTOSCALE_REFIT_RTOL:
        raise RuntimeError(f"the fit {fit} against the tenant's windows {rows}: numpy's "
                           f"refit {refit}, off by {refit_err:.3g} (limit "
                           f"{AUTOSCALE_REFIT_RTOL})")
    return {"windows": rows, "refit": refit, "refit_err": refit_err,
            "r_max_over_seen": float(fit["r_max"]) / max(r["rate"] for r in rows)}


def _autoscale_flows(stack: _MasterStack, dev_dir: str, ops_base: str, read: str, live: bool,
                     on_mounted) -> dict:
    """The flows of ``autoscale_check``; raises on the first check that does
    not hold."""
    cluster, app = stack.cluster, stack.app
    node = cluster.node_name
    pod = cluster.add_target_pod("tenant-autoscale")
    tenant = f"{pod.namespace}/{pod.name}"
    intent_path = f"/intents/{pod.namespace}/{pod.name}"
    free = cluster.free_gpu_count()
    out: dict = {"collect_ms": []}
    status, body, out["add_ms"] = stack.http("GET", _add_path(pod, 1))
    if (status, body) != (200, "Add GPU Success\n"):
        raise RuntimeError(f"GET {_add_path(pod, 1)}: {status} {body!r}")
    uuids = stack.held(node, pod)
    _check_nodes(cluster.backend, uuids, dev_dir, live)
    status, body, out["put_ms"] = stack.http("PUT", intent_path,
                                             payload={"desiredChips": 1, "minChips": 1})
    if status != 200 or json.loads(body)["desiredChips"] != 1:
        raise RuntimeError(f"PUT {intent_path}: {status} {body}")

    def collect() -> float:
        _, ms = _timed(app.fleet.collect_once, _HOST)
        out["collect_ms"].append(ms)
        return ms

    out["tenant"] = on_mounted(uuids, dev_dir, ops_base, stack.token, collect)
    if len(out["collect_ms"]) != len(AUTOSCALE_WINDOWS):
        raise RuntimeError(f"the tenant ran {len(out['collect_ms'])} collection pass(es) for "
                           f"{len(AUTOSCALE_WINDOWS)} windows")
    status, body, out["get_ms"] = stack.http("GET", "/autoscale", token=read)
    pane = json.loads(body) if status == 200 else {}
    fit = (pane.get("model") or {}).get("tenants", {}).get(tenant) or {}
    if status != 200 or fit.get("verdict") != "ok" or fit.get("samples") != 4:
        raise RuntimeError(f"GET /autoscale with the read token: {status}, {tenant}'s fit "
                           f"{fit}")
    out["fit"] = fit
    out["fit_vs_windows"] = _fit_vs_windows(fit, out["tenant"]["windows"])
    out["expected"] = _expected_reasons(fit, AUTOSCALE_QUEUE, app.cfg)
    records_before = len(audit.AUDIT.query(operation="autoscale.decision"))
    out["evaluate"] = []
    for want in out["expected"]:
        status, body, ms = stack.http("POST", "/autoscale/evaluate")
        record = json.loads(body) if status == 200 else {}
        (decision,) = [d for d in record.get("decisions", []) if d["tenant"] == tenant] or [{}]
        if status != 200 or decision.get("action") != "hold" or decision.get("reason") != want:
            raise RuntimeError(f"POST /autoscale/evaluate: {status}, {tenant}'s decision "
                               f"{decision}, the rule's {want!r}")
        out["evaluate"].append({"ms": ms, "reason": decision["reason"],
                                "queue_depth": decision.get("queue_depth"),
                                "feasibility": decision.get("feasibility")})
    status, body, _ = stack.http("GET", intent_path)
    if status != 200 or json.loads(body)["desiredChips"] != 1 \
            or stack.held(node, pod) != uuids \
            or len(audit.AUDIT.query(operation="autoscale.decision")) != records_before:
        raise RuntimeError(f"the holds moved something: GET {intent_path} {status} {body}, "
                           f"held {stack.held(node, pod)} (was {uuids})")
    # the pause: evaluate refused with its cause until the resume
    codes = {}
    for step, path in (("pause", "/autoscale/pause"), ("paused", "/autoscale/evaluate"),
                       ("resume", "/autoscale/resume"), ("resumed", "/autoscale/evaluate")):
        status, body, ms = stack.http("POST", path)
        codes[step] = (status, ms)
        if step == "paused" and (status, "operator-paused" in body) != (409, True):
            raise RuntimeError(f"POST {path} while paused: {status} {body!r}")
        if step != "paused" and status != 200:
            raise RuntimeError(f"POST {path}: {status} {body!r}")
    out["pause"] = codes
    status, body, _ = stack.http("DELETE", intent_path)
    if status != 200:
        raise RuntimeError(f"DELETE {intent_path}: {status} {body!r}")
    status, body, out["remove_ms"] = stack.http("POST", _remove_path(pod),
                                                {"uuids": ",".join(uuids)})
    if (status, body) != (200, "Remove 1 GPUs Success\n"):
        raise RuntimeError(f"POST {_remove_path(pod)} {uuids}: {status} {body!r}")
    _released(cluster, pod, free)
    out["uuids"] = uuids
    return out


def autoscale_check(device="cuda", *, dev_dir: str | None = None, ns_pid: int | None = None,
                    cgroup_dirs=(), identity: str = "nvml", ledger_root: str | None = None,
                    on_mounted=None) -> dict:
    """The autoscaler on a live hot-mount (``_MasterStack`` over HTTP and
    gRPC, the master with a read token beside its mutate token, the worker's
    ops port on a free port of 127.0.0.1, a ledger in a new directory under
    `ledger_root`, the collector's passes by hand, the autoscaler's loop
    off). Without grpcio it raises ``ModuleNotFoundError`` naming grpcio.

    An HTTP add mounts one GPU into a pod and PUT /intents declares it
    (desired 1, min 1). on_mounted(uuids, dev_dir, ops_url, token, collect)
    is the tenant: it runs the AUTOSCALE_WINDOWS windows of AUTOSCALE_STEPS
    steps, each step of B rows of AUTOSCALE_ROW tokens at the queue depth
    AUTOSCALE_QUEUE, publishes its snapshot to the ops port after each
    window and calls collect() (one pass of the fleet collector, whose
    throughput observer is the autoscaler's model); on the card a process on
    the GPU, on the CPU ``autoscale_tenant_cpu`` by default. Then GET
    /autoscale (the read token) shows the tenant's fit ``ok`` with 4
    samples, and the fit describes the windows it came from
    (``_fit_vs_windows``); two POST /autoscale/evaluate end in the reasons the
    reference's rule gives that fit and queue (``_expected_reasons``:
    hysteresis then infeasible at a utilization of AUTOSCALE_UTIL_GROW or
    more, the one GPU being held; else steady), and neither moves the
    intent, the mount or the audit trail's decisions; POST /autoscale/pause
    makes evaluate answer 409 (operator-paused), and the resume 200. The
    intent is deleted and the GPU removed.

    On the card (device="cuda") on the live ``NvidiaDeviceBackend`` mounting
    into `dev_dir` through the mount namespace of `ns_pid` (as
    ``mount_check``), and without CAP_MKNOD it raises; on the CPU on a fake
    host of 1 GPU. Runs on the card unless the caller passes device="cpu".

    Returns {"cap_mknod", "live" or "fake": {"start_ms", "add_ms", "put_ms",
    "tenant", "collect_ms", "get_ms", "fit", "fit_vs_windows", "expected", "evaluate",
    "pause", "remove_ms", "uuids"}, the other None}; ms on the host
    clock."""
    device = resolve_device(device)
    live = device.type == "cuda"
    report = {"cap_mknod": has_cap_mknod(), "live": None, "fake": None}
    if live and not report["cap_mknod"]:
        raise RuntimeError("autoscale_check on the card needs CAP_MKNOD: its tenant runs on "
                           "the card's own GPU, mounted")
    if live and on_mounted is None:
        raise ValueError("autoscale_check on the card needs its tenant: on_mounted(uuids, "
                         "dev_dir, ops_url, token, collect) running on the GPU")
    k8s_health.reset_all()
    root = tempfile.mkdtemp(prefix="autoscale-check-")
    ledgers = tempfile.mkdtemp(prefix="autoscale-ledgers-", dir=ledger_root)
    read = secrets.token_hex(16)
    try:
        t0 = time.perf_counter()
        cfg = Config(auth_mode="token", auth_token=secrets.token_hex(16), auth_read_token=read,
                     ledger_dir=ledgers, node_name="gpu-node-0", fleet_scrape_interval_s=3600.0)
        if live:
            cluster = FakeCluster(NvidiaDeviceBackend("/dev", identity=make_identity(identity)),
                                  cfg=cfg, node_name=cfg.node_name)
        else:
            cluster = FakeCluster.with_fake_gpus(os.path.join(root, "fake"), 1, cfg=cfg)
        target, dirs = _live_target(root, dev_dir, cgroup_dirs)
        ops = serve_ops(0, cfg, host="127.0.0.1")
        try:
            with _MasterStack(cluster, {cluster.node_name: target}, ns_pid if live else None,
                              dirs) as stack:
                flows = {"start_ms": (time.perf_counter() - t0) * 1e3}
                flows.update(_autoscale_flows(
                    stack, target, f"http://127.0.0.1:{ops.server_address[1]}", read, live,
                    on_mounted or autoscale_tenant_cpu))
        finally:
            ops.shutdown()
            ops.server_close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(ledgers, ignore_errors=True)
        k8s_health.reset_all()
    report["live" if live else "fake"] = flows
    return report


# --- the operator's CLI against the live stack ---

#: the CLI as the operator runs it
CLI_MODULE = "gpumounter_tpu_torch.cli"
#: what importing the CLI may not load: the daemons' images carry none of
#: them, and each verb is a process start in the operator's loop
CLI_UNLOADED = ("torch", "numpy", "grpc")
#: the capacity shape of one GPU, and a shape the port does not know
CLI_SHAPE, CLI_UNKNOWN_SHAPE = "nvidia-h100-80gb-1", "v5litepod-4"
#: the keys of `devices --busy`, as the reference's
CLI_DEVICE_KEYS = {"index", "uuid", "path", "major", "minor", "holder_pids"}
#: the keys of `probe`, the port's (ROADMAP §3)
CLI_PROBE_KEYS = {"identity_source", "nvml", "gpus", "cgroup_version", "cgroup_driver",
                  "nsexec", "nsexec_built", "native_lib", "native_lib_built"}


def _package_parent() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Cli:
    """``python -m gpumounter_tpu_torch.cli`` in a process of its own, one a
    verb, from the package's parent directory: the mutate token in
    TPUMOUNTER_AUTH_TOKEN (no other TPUMOUNTER_AUTH* of this process's),
    `env` over this process's environment. ``ms`` holds each verb's wall
    time from spawn to exit (host clock) under its name."""

    def __init__(self, token: str, env: dict):
        self.env = {k: v for k, v in os.environ.items() if not k.startswith("TPUMOUNTER_AUTH")}
        path = self.env.get("PYTHONPATH")
        self.env["PYTHONPATH"] = _package_parent() + (os.pathsep + path if path else "")
        self.env.update(TPUMOUNTER_AUTH_TOKEN=token, **env)
        self.ms: dict[str, list[float]] = {}

    def run(self, argv: list[str], name: str | None = None) -> tuple[int, str, str]:
        t0 = time.perf_counter()
        out = subprocess.run(argv, capture_output=True, text=True, timeout=120, env=self.env,
                             cwd=_package_parent())
        self.ms.setdefault(name or argv[-1], []).append((time.perf_counter() - t0) * 1e3)
        return out.returncode, out.stdout, out.stderr

    def __call__(self, *args: str, want: int | None = 0, name: str | None = None
                 ) -> tuple[int, str, str]:
        """One verb; raises unless it exits `want` (None: any code)."""
        code, stdout, stderr = self.run([sys.executable, "-m", CLI_MODULE, *args],
                                        name or args[0])
        if want is not None and code != want:
            raise RuntimeError(f"cli {' '.join(args)}: exit {code}, expected {want}\n"
                               f"{stdout[-2000:]}\n{stderr[-2000:]}")
        return code, stdout, stderr


def _cli_devices(cli: _Cli, backend, dev, live: bool) -> dict:
    """`devices --busy`: every GPU of the backend with the reference's keys,
    this process among the holders of `dev`, as the backend's own /proc
    scan finds it (the card: this process holds a CUDA context; a fake
    host: this process holds the node open). On the card the UUID is
    CUDA's own and the node /dev/nvidia<minor> of major 195."""
    held = None if live else open(dev.device_path, "rb")
    try:
        _, stdout, _ = cli("devices", "--busy")
        scan = backend.running_pids(dev)
    finally:
        if held is not None:
            held.close()
    listed = json.loads(stdout)
    want = {d.uuid: d for d in backend.list_devices()}
    if sorted(e["uuid"] for e in listed) != sorted(want) \
            or any(set(e) != CLI_DEVICE_KEYS for e in listed):
        raise RuntimeError(f"devices --busy: {listed}, the backend's {sorted(want)}")
    (entry,) = [e for e in listed if e["uuid"] == dev.uuid]
    if (entry["path"], entry["major"], entry["minor"]) != (dev.device_path, dev.major, dev.minor) \
            or os.getpid() not in entry["holder_pids"] or os.getpid() not in scan:
        raise RuntimeError(f"devices --busy: {entry}; this process {os.getpid()}, the scan's "
                           f"holders {scan}")
    if live:
        cuda = f"GPU-{torch.cuda.get_device_properties(0).uuid}"
        if (entry["uuid"], entry["path"], entry["major"]) != (
                cuda, f"/dev/nvidia{entry['minor']}", 195):
            raise RuntimeError(f"devices --busy: {entry}, CUDA's device 0 is {cuda}")
    return entry


def _cli_probe(cli: _Cli, backend, identity: str) -> dict:
    """`probe`: the port's keys, the backend's GPU count, the identity
    source the env names, this process's cgroup version and the native
    layer's paths and whether each is built, as this process sees them."""
    from gpumounter_tpu_torch import native
    from gpumounter_tpu_torch.cgroup import detect_cgroup_version

    _, stdout, _ = cli("probe")
    report = json.loads(stdout)
    want = {"gpus": len(backend.list_devices()), "identity_source": identity,
            "cgroup_version": detect_cgroup_version(), **native.status()}
    if set(report) != CLI_PROBE_KEYS or any(report[k] != v for k, v in want.items()):
        raise RuntimeError(f"probe: {report}, expected {want} among {sorted(CLI_PROBE_KEYS)}")
    return report


def _cli_trace(cli: _Cli, base: str, read: list[str], pod) -> dict:
    """`audit --pod` shows the add's records (http.add and the worker's
    AddGPU under one trace id); `trace <id>` and `why <id>` exit 0, `why`
    naming the dominant phase and its share; `trace` of 32 zeros exits 2."""
    _, stdout, _ = cli("audit", "--master", base, *read, "--pod", pod.name)
    records = json.loads(stdout)["records"]
    ops = {r["operation"]: r for r in records}
    if "http.add" not in ops or "worker.AddGPU" not in ops \
            or ops["http.add"]["trace_id"] != ops["worker.AddGPU"]["trace_id"]:
        raise RuntimeError(f"audit --pod {pod.name}: {records}")
    tid = ops["http.add"]["trace_id"]
    _, stdout, _ = cli("trace", "--master", base, *read, tid)
    if json.loads(stdout).get("op") != "http.add":
        raise RuntimeError(f"trace {tid}: {stdout[:2000]}")
    _, stdout, _ = cli("why", "--master", base, *read, tid)
    dominant = [line for line in stdout.splitlines() if line.startswith("dominant phase: ")]
    if len(dominant) != 1 or "% of wall time)" not in dominant[0]:
        raise RuntimeError(f"why {tid}: {stdout!r}")
    cli("trace", "--master", base, *read, "0" * 32, want=2, name="trace (unknown id)")
    return {"trace_id": tid, "dominant": dominant[0][len("dominant phase: "):]}


def _cli_capacity(cli: _Cli, base: str, read: list[str], total: int) -> dict:
    """`capacity` exits 0 with the GPU held (the fleet pass before it saw
    the add); `--accel-type` of one GPU exits as the reference's rule gives
    for the pane it printed (3 when infeasible, else 0); an unknown shape
    exits 2."""
    _, stdout, _ = cli("capacity", "--master", base, *read)
    fleet = json.loads(stdout)["fleet"]
    if (fleet["total"], fleet["held"]) != (total, 1):
        raise RuntimeError(f"capacity: fleet {fleet}, {total} GPU(s) with one held expected")
    code, stdout, _ = cli("capacity", "--master", base, *read, "--accel-type", CLI_SHAPE,
                          want=None, name=f"capacity --accel-type {CLI_SHAPE}")
    verdict = json.loads(stdout)["feasibility"][CLI_SHAPE]["verdict"]
    if code != (3 if verdict == "infeasible" else 0):
        raise RuntimeError(f"capacity --accel-type {CLI_SHAPE}: exit {code}, verdict {verdict}")
    cli("capacity", "--master", base, *read, "--accel-type", CLI_UNKNOWN_SHAPE, want=2,
        name=f"capacity --accel-type {CLI_UNKNOWN_SHAPE}")
    return {"fleet": fleet, "verdict": verdict, "exit": code}


def _cli_flows(stack: _MasterStack, cli: _Cli, target: str, live: bool, identity: str,
               repeats: int, on_mounted) -> dict:
    """Phase 22's steps on `stack` (see ``cli_check``)."""
    cluster, base = stack.cluster, stack.base
    read = ["--read-token", stack.cfg.auth_read_token]
    backend = cluster.backend
    node = cluster.node_name
    dev = backend.list_devices()[0]
    out = {"devices": _cli_devices(cli, backend, dev, live),
           "probe": _cli_probe(cli, backend, identity)}
    cap = has_cap_mknod() or not live
    pod = cluster.add_target_pod("tenant-cli-1")
    free = cluster.free_gpu_count()
    add = ["add", "--master", base, "--pod", pod.name, "--num", "1"]
    out.update(cli_add_ms=[], cli_remove_ms=[], uuids=None, refusal=None, tenant=None)
    for i in range(repeats):
        code, stdout, _ = cli(*add, want=None)
        out["cli_add_ms"].append(cli.ms["add"][-1])
        if not cap:
            if code != 1 or "CAP_MKNOD" not in stdout:
                raise RuntimeError(f"cli add without CAP_MKNOD: exit {code} {stdout!r}")
            _released(cluster, pod, free)
            out["refusal"] = stdout.strip()
            continue
        if (code, stdout) != (0, "Add GPU Success\n"):
            raise RuntimeError(f"cli {' '.join(add)}: exit {code} {stdout!r}")
        uuids = stack.held(node, pod)
        if len(uuids) != 1 or cluster.free_gpu_count() != free - 1:
            raise RuntimeError(f"cli add: {uuids} held, {cluster.free_gpu_count()} free of "
                               f"{free}")
        _check_nodes(backend, uuids, target, live)
        if i == 0:
            if on_mounted is not None:
                out["tenant"] = on_mounted(uuids, target)
            out.update(_cli_trace(cli, base, read, pod))
            stack.app.fleet.collect_once()
            out["capacity"] = _cli_capacity(cli, base, read, len(backend.list_devices()))
            n = len(cluster.assignment) + 1
            _, stdout, _ = cli("add", "--master", base, "--pod", pod.name, "--num", str(n),
                               want=1, name=f"add --num {n}")
            if not stdout.startswith("Insufficient GPU on Node: "):
                raise RuntimeError(f"cli add --num {n}: {stdout!r}")
            _, stdout, _ = cli(*add, "--token", "", want=1, name="add --token ''")
            if stdout.strip() != "missing or invalid bearer token":
                raise RuntimeError(f"cli add --token '': {stdout!r}")
        code, stdout, _ = cli("remove", "--master", base, "--pod", pod.name, "--uuids",
                              uuids[0], want=None)
        out["cli_remove_ms"].append(cli.ms["remove"][-1])
        if (code, stdout) != (0, "Remove 1 GPUs Success\n"):
            raise RuntimeError(f"cli remove {uuids}: exit {code} {stdout!r}")
        if os.path.lexists(os.path.join(target, backend.device_by_uuid(uuids[0]).basename)):
            raise RuntimeError(f"{uuids[0]}'s node still in {target} after cli remove")
        _released(cluster, pod, free)
        out["uuids"] = uuids
    if not cap:
        cli("audit", "--master", base, *read, "--pod", pod.name)
        cli("trace", "--master", base, *read, "0" * 32, want=2, name="trace (unknown id)")
    stack.app.fleet.collect_once()
    for verb in ("fleet", "apihealth", "shards"):
        cli(verb, "--master", base, *read)
    # the same add and remove over HTTP from this process, on the same stack
    http_pod = cluster.add_target_pod("tenant-http-cli")
    out["http_add_ms"], out["http_remove_ms"] = [], []
    for _ in range(repeats if cap else 0):
        status, body, ms = stack.http("GET", _add_path(http_pod, 1))
        out["http_add_ms"].append(ms)
        if (status, body) != (200, "Add GPU Success\n"):
            raise RuntimeError(f"GET {_add_path(http_pod, 1)}: {status} {body!r}")
        status, body, ms = stack.http("POST", _remove_path(http_pod),
                                      {"uuids": ",".join(stack.held(node, http_pod))})
        out["http_remove_ms"].append(ms)
        if (status, body) != (200, "Remove 1 GPUs Success\n"):
            raise RuntimeError(f"POST {_remove_path(http_pod)}: {status} {body!r}")
    return out


def cli_check(device="cuda", *, dev_dir: str | None = None, ns_pid: int | None = None,
              cgroup_dirs=(), identity: str = "nvml", fake_gpus: int = 8, repeats: int = 3,
              on_mounted=None) -> dict:
    """The operator's verbs against the live stack: ``_MasterStack`` (the
    master over HTTP with a read token beside its mutate token, the worker
    over gRPC), each verb ``python -m gpumounter_tpu_torch.cli`` in a process
    of its own with the mutate token in TPUMOUNTER_AUTH_TOKEN and the read
    verbs given --read-token, every exit code asserted. Without grpcio it
    raises ``ModuleNotFoundError`` naming grpcio.

    In order: `devices --busy` lists the host's GPUs with the reference's
    keys and this process among the first one's holders; `probe` reports the
    backend's count, the identity source, this process's cgroup version and
    the namespace helper; `add --num 1` into tenant-cli-1 mounts a GPU (the
    node in the target directory; on_mounted(uuids, dev_dir) runs once,
    its return kept as "tenant"), `audit --pod` shows the add's records,
    `trace` and `why` of its trace id exit 0 (`why` naming the dominant
    phase), `trace` of 32 zeros exits 2; after a fleet pass `capacity`
    exits 0 with the GPU held, `--accel-type nvidia-h100-80gb-1` as the
    reference's rule gives its verdict, an unknown shape 2; `add` of one GPU
    more than the host has exits 1 (500 Insufficient), `add --token ''` 1
    (401); `remove --uuids` exits 0 (the node gone, the slave pod
    released); after a second pass `fleet`, `apihealth` and `shards` exit
    0. The add and remove run `repeats` times (the steps between them the
    first time only), and as many HTTP adds and removes from this process
    on the same stack for comparison. Without CAP_MKNOD each add exits 1
    naming it, rolled back, and nothing is removed.

    On the card (device="cuda") on the live ``NvidiaDeviceBackend`` (its
    `identity`) mounting into `dev_dir` through the mount namespace of
    `ns_pid` (as ``mount_check``): `devices` names CUDA's UUID at
    /dev/nvidia<minor>, major 195; on the CPU on a fake host of `fake_gpus`
    GPUs (FAKE_DEVICE_DIR), this process holding the first node open. Runs
    on the card unless the caller passes device="cpu".

    Returns {"cap_mknod", "import_ms" (`python -c "import
    gpumounter_tpu_torch.cli"`, asserting that none of CLI_UNLOADED is
    loaded, `repeats` times), "live" or "fake": {"devices", "probe",
    "cli_add_ms", "cli_remove_ms", "http_add_ms", "http_remove_ms", "uuids",
    "refusal", "tenant", "trace_id", "dominant", "capacity", "verb_ms"
    (each verb's spawn-to-exit times)}, the other None}; ms on the host
    clock."""
    device = resolve_device(device)
    live = device.type == "cuda"
    report = {"cap_mknod": has_cap_mknod(), "live": None, "fake": None}
    cfg = Config(auth_mode="token", auth_token=secrets.token_hex(16),
                 auth_read_token=secrets.token_hex(16), fleet_scrape_interval_s=3600.0)
    root = tempfile.mkdtemp(prefix="cli-check-")
    try:
        if live:
            cluster = FakeCluster(NvidiaDeviceBackend("/dev", identity=make_identity(identity)),
                                  cfg=cfg)
            env = {"GPU_IDENTITY_SOURCE": identity}
        else:
            cluster = FakeCluster.with_fake_gpus(os.path.join(root, "fake"), fake_gpus, cfg=cfg)
            env = {"GPU_IDENTITY_SOURCE": identity, "FAKE_DEVICE_DIR": cluster.backend.root}
        cli = _Cli(cfg.auth_token, env)
        probe = ("import sys, " + CLI_MODULE + "\n"
                 f"loaded = [m for m in {CLI_UNLOADED!r} if m in sys.modules]\n"
                 "assert not loaded, loaded\n")
        for _ in range(repeats):
            code, _, stderr = cli.run([sys.executable, "-c", probe], "import")
            if code != 0:
                raise RuntimeError(f"import {CLI_MODULE}: {stderr[-2000:]}")
        report["import_ms"] = cli.ms.pop("import")
        if live:
            target, dirs = _live_target(root, dev_dir, cgroup_dirs)
        else:
            target, dirs = os.path.join(root, "tenant-dev"), ()
            os.makedirs(target)
        with _MasterStack(cluster, {cluster.node_name: target}, ns_pid if live else None,
                          dirs) as stack:
            flows = _cli_flows(stack, cli, target, live, identity, repeats, on_mounted)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    flows["verb_ms"] = cli.ms
    report["live" if live else "fake"] = flows
    return report
