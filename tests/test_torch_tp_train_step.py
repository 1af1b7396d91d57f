"""The port's dp x tp train steps against the reference's on the CPU.

The reference runs ``make_train_step(mesh, cfg)`` and
``make_train_step_optax`` under GSPMD on the virtual CPU devices of
``tests/conftest.py``, with ``attn_backend="xla"``, on a 2 x 2 mesh
(``Mesh(devices[:4].reshape(2, 2))``) and on ``build_mesh(devices[:2])``
(1 x 2). The port runs the same weights and tokens on 4 and 2 gloo ranks
(``parallel.launch.run_ranks``), one spawn per world shape with every case
inside it (``torch_mesh_ranks.train_cases``), and each rank gathers the
new params (``gather_params``): the checks compare whole leaves, never
shards.
"""

from __future__ import annotations

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from gpumounter_tpu.models import probe as jprobe
from gpumounter_tpu.parallel import mesh as jmesh
from gpumounter_tpu.parallel import train_step as jts
from gpumounter_tpu_torch.entry import TRAIN_GRAD_ATOL, tp_train_check
from gpumounter_tpu_torch.parallel.launch import run_ranks

import torch_mesh_ranks
from test_torch_probe import SMALL, _jax_cfg

# One spawn of gloo ranks per world shape, its own time limit: a hung rank
# fails the tests of this module, not the suite's clock.
SPAWN_TIMEOUT_S = 240.0
SHAPES = {"2x2": (2, 2), "1x2": (1, 2)}
GQA = dict(SMALL, n_kv_heads=2, window=5, rope=True)
# The reference's dryrun flagship (__graft_entry__._flagship_cfg): 16 q
# heads, 8 kv heads, d_head 4.
FLAGSHIP = dict(n_layers=2, d_model=64, n_heads=16, d_ff=128, max_len=32,
                n_kv_heads=8, window=8, rope=True)
ADAMW = dict(lr=1e-2, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
LR = 0.1


def _batches(cfg, n, seed, shape=(4, 8)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, shape) for _ in range(n)]


# name: (config fields, kind, seed, steps). f32 throughout where the port
# is held to the reference: the two differ only in the order of the sums
# (GSPMD's partial products and psums against the port's f and g, the
# batch mean against the mean of the data shards' means).
CASES = {
    "gqa_window_rope_f32_sgd": (dict(GQA, dtype="float32"), "sgd", 0, 2),
    "mha_learned_pos_f32_sgd": (dict(SMALL, dtype="float32"), "sgd", 1, 1),
    "flagship_d_head4_f32_sgd": (dict(FLAGSHIP, dtype="float32"), "sgd", 2, 1),
    "gqa_window_rope_f32_adamw": (dict(GQA, dtype="float32"), "adamw", 3, 2),
    # bf16, held to the port's own one-device step (below).
    "gqa_window_rope_bf16_sgd": (dict(GQA, dtype="bfloat16"), "sgd", 4, 1),
}


def _port_cases():
    cases, refs = {}, {}
    for name, (fields, kind, seed, steps) in CASES.items():
        cfg = torch_mesh_ranks.config(fields)
        jparams = jprobe.init_params(_jax_cfg(cfg), jax.random.key(seed))
        batches = _batches(cfg, steps, seed=100 + seed)
        tree = jax.tree.map(np.asarray, jparams)
        case = {"kind": kind, "fields": fields, "tree": tree, "batches": batches}
        if kind == "sgd":
            case["lr"] = LR
        else:
            case["adamw"] = ADAMW
        case["single"] = fields["dtype"] == "bfloat16"
        cases[name] = case
        refs[name] = (cfg, jparams, batches)
    return cases, refs


@pytest.fixture(scope="module")
def runs():
    """{shape: (per-rank results, reference inputs)}."""
    cases, refs = _port_cases()
    return {shape: run_ranks(torch_mesh_ranks.train_cases, n * m, backend="gloo",
                             args=((n, m), cases), timeout_s=SPAWN_TIMEOUT_S)
            for shape, (n, m) in SHAPES.items()}, refs


def _reference_mesh(shape):
    devices = jax.devices("cpu")
    if shape == "2x2":
        return Mesh(np.array(devices[:4]).reshape(2, 2), ("data", "model"))
    return jmesh.build_mesh(devices[:2])


def _reference(name, shape, refs):
    """(losses, new params as numpy) of the reference's sharded steps."""
    cfg, jparams, batches = refs[name]
    kind = CASES[name][1]
    mesh, jcfg = _reference_mesh(shape), _jax_cfg(cfg)
    params = jts.shard_params(jparams, mesh, jcfg)
    losses = []
    if kind == "sgd":
        step = jts.make_train_step(mesh, jcfg, LR)
        for tokens in batches:
            params, loss = step(params, jnp.asarray(tokens, jnp.int32))
            losses.append(float(loss))
    else:
        init_fn, step_fn = jts.make_train_step_optax(
            mesh, jcfg, optax.adamw(ADAMW["lr"], b1=0.9, b2=0.999, eps=ADAMW["eps"],
                                    weight_decay=ADAMW["weight_decay"]))
        state = init_fn(params)
        for tokens in batches:
            params, state, loss = step_fn(params, state, jnp.asarray(tokens, jnp.int32))
            losses.append(float(loss))
    return losses, jax.tree.map(lambda a: np.asarray(a, np.float32), params)


def _leaves(tree):
    top = [tree[k] for k in sorted(tree) if k != "blocks"]
    return top + [blk[k] for blk in tree["blocks"] for k in sorted(blk)]


def _names(tree):
    top = [k for k in sorted(tree) if k != "blocks"]
    return top + [f"blocks[{i}].{k}" for i, blk in enumerate(tree["blocks"]) for k in sorted(blk)]


# (loss atol, params atol) against the reference, f32: the sums' order
# only, as the one-device parity tests hold them (test_torch_train_step).
F32_SGD_TOL = (2e-6, 1e-6)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("name", [n for n in CASES if n.endswith("f32_sgd")])
def test_sgd_step_matches_reference(runs, name, shape):
    results, refs = runs
    want_losses, want = _reference(name, shape, refs)
    got = results[shape][0][name]
    loss_atol, atol = F32_SGD_TOL
    np.testing.assert_allclose(got["losses"], want_losses, rtol=0, atol=loss_atol)
    for leaf_name, g, w in zip(_names(want), _leaves(got["params"]), _leaves(want),
                               strict=True):
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=leaf_name)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_adamw_step_matches_optax(runs, shape):
    """2 AdamW steps: Adam divides each grad by sqrt(v), so where a grad is
    near 0 its f32 rounding differences reach the update whole; 1e-4 as
    the one-device AdamW test allows (test_torch_train_step)."""
    results, refs = runs
    name = "gqa_window_rope_f32_adamw"
    want_losses, want = _reference(name, shape, refs)
    got = results[shape][0][name]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=0, atol=2e-6)
    for leaf_name, g, w in zip(_names(want), _leaves(got["params"]), _leaves(want),
                               strict=True):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4, err_msg=leaf_name)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_bf16_step_matches_the_one_device_step(runs, shape):
    """bf16, the port's sharded step against its one-device step on the
    same full params: g sums bf16 partial products (one rounding each)
    where one matmul rounds once, and the data shards' bf16 grads are
    summed in bf16, so each new weight is p − lr·g rounded to bf16 from a
    g a few bf16 ulps off; the update can round a weight to its
    neighbour: within 1 ulp of each leaf's max |value| (2^-7 of it, as a
    bf16 ulp is 2^-7 of a value in [1, 2)). The loss: an f32 mean of
    logits an ulp apart, within 1e-3."""
    results, _ = runs
    got = results[shape][0]["gqa_window_rope_bf16_sgd"]
    single = got["single"]
    assert abs(got["losses"][-1] - single["loss"]) < 1e-3
    for leaf_name, g, w in zip(_names(single["params"]), _leaves(got["params"]),
                               _leaves(single["params"]), strict=True):
        np.testing.assert_allclose(g, w, rtol=0, atol=2**-7 * np.abs(w).max(),
                                   err_msg=leaf_name)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_every_rank_ends_with_the_same_params(runs, shape):
    """The gathered params, hence each replicated leaf and each shard, are
    bit-equal on every rank after the steps, and so are the losses."""
    results, _ = runs
    first = results[shape][0]
    for rank, other in enumerate(results[shape][1:], start=1):
        for name in CASES:
            assert other[name]["losses"] == first[name]["losses"], (name, rank)
            for g, w in zip(_leaves(other[name]["params"]), _leaves(first[name]["params"]),
                            strict=True):
                np.testing.assert_array_equal(g, w, err_msg=f"{name} rank {rank}")


@pytest.mark.parametrize("shape", list(SHAPES))
def test_each_rank_holds_only_its_shards(runs, shape):
    """Local shapes: wqkv and w1 split by columns, wo and w2 by rows over
    "model"; with GQA a rank holds its q heads' and its kv heads'
    columns."""
    results, refs = runs
    n_model = SHAPES[shape][1]
    cfg, _, _ = refs["gqa_window_rope_f32_sgd"]
    qkv = (cfg.n_heads + 2 * cfg.kv_heads) * cfg.d_head
    block = {"ln1": (cfg.d_model,), "ln2": (cfg.d_model,),
             "w1": (cfg.d_model, cfg.d_ff // n_model), "w2": (cfg.d_ff // n_model, cfg.d_model),
             "wo": (cfg.d_model // n_model, cfg.d_model), "wqkv": (cfg.d_model, qkv // n_model)}
    want = [(cfg.vocab, cfg.d_model)] + [block[k] for _ in range(cfg.n_layers)
                                         for k in sorted(block)]
    for result in results[shape]:
        assert result["gqa_window_rope_f32_sgd"]["shapes"] == want


@pytest.mark.parametrize("shape", list(SHAPES))
def test_collectives_a_step_follow_the_formula(runs, shape):
    """step_collectives' formula: over "model" 4 a block, each of an
    activation of the rank's rows (B/dp, T, d_model); over "data" one
    gradient sum a leaf, of the rank's shard, and the 4-byte loss; an axis
    of size 1 runs none. No weight is gathered."""
    results, refs = runs
    n_data, n_model = SHAPES[shape]
    for name in CASES:
        cfg, _, batches = refs[name]
        item = cfg.dtype.itemsize
        rows, seq = batches[0].shape[0] // n_data, batches[0].shape[1]
        for result in results[shape]:
            shard_bytes = sum(int(np.prod(s)) * item for s in result[name]["shapes"])
            calls = {"model": 4 * cfg.n_layers if n_model > 1 else 0,
                     "data": len(result[name]["shapes"]) + 1 if n_data > 1 else 0}
            nbytes = {"model": calls["model"] * rows * seq * cfg.d_model * item,
                      "data": shard_bytes + 4 if n_data > 1 else 0}
            assert result[name]["counts"] == {"calls": calls, "bytes": nbytes}, name


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_tp_train_check_runs_on_cpu(shape):
    """The dryrun's sharded sections on gloo ranks on the CPU (the plain
    attention on both sides of the grad check, so the error is the bf16
    of the autograd Function's plain backward against autograd through
    the plain forward)."""
    result = tp_train_check(*shape, device="cpu", backend="gloo", timeout_s=SPAWN_TIMEOUT_S)
    assert len(result["ranks"]) == shape[0] * shape[1]
    assert np.isfinite(result["loss"]) and np.isfinite(result["moe_loss"])
    assert 0 <= result["max_grad_err"] < TRAIN_GRAD_ATOL
    assert result["heads"] == [(16 // shape[1], 8 // shape[1])] * 2
    assert result["launches"] == {"flash_fwd": 0, "dq": 0, "dkv": 0}  # no kernel on the CPU
    assert all(np.isfinite(result["moe_step_losses"]))
    assert len({r["loss"] for r in result["ranks"]}) == 1


def test_tp_train_check_names_the_backend_it_was_given():
    with pytest.raises(TypeError, match="backend"):
        tp_train_check(1, 2, device="cpu")
