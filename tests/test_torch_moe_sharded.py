"""Expert parallelism of the port against the reference's on the CPU.

Two layouts, as in the reference's dryrun: the MoE flagship (8 experts)
trained dp x tp with its experts split over "model"
(``make_train_step(mesh, cfg)``), and the standalone MoE layer's step over
("data", "expert") (``make_moe_step(mesh, ...)``). The reference runs under
GSPMD on the virtual CPU devices of ``tests/conftest.py`` (a 2 x 2 mesh
from ``devices[:4]`` and ``build_mesh(devices[:2])``'s 1 x 2); the port
runs on 4 and 2 gloo ranks, one spawn per world shape with every case
inside it, and the checks compare gathered whole leaves.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gpumounter_tpu.models import probe as jprobe
from gpumounter_tpu.parallel import mesh as jmesh
from gpumounter_tpu.parallel import moe as jmoe
from gpumounter_tpu.parallel import train_step as jts
from gpumounter_tpu_torch.parallel.launch import run_ranks

import torch_mesh_ranks
from test_torch_probe import _jax_cfg

SPAWN_TIMEOUT_S = 240.0  # its own limit: a hung rank fails this module only
SHAPES = {"2x2": (2, 2), "1x2": (1, 2)}
# The dryrun's MoE flagship (__graft_entry__.py:195-201): the flagship's
# dialect with 8 experts and d_ff 64.
MOE8 = dict(n_layers=2, d_model=64, n_heads=16, d_ff=64, max_len=32, n_kv_heads=8,
            window=8, rope=True, n_experts=8)
LR = 0.1
# The standalone layer's sizes (__graft_entry__.py:268-284): 2 experts a
# rank of the "expert" axis, d_model 32, d_ff 64.
D_MODEL, D_FF, EP = 32, 64, 2


def _expert_mesh_shape(world):
    return (world // EP, EP)


def _moe_step_case(dtype, seed, steps, world):
    """The standalone layer: weights from the reference's init_moe_params,
    x and target (8, 32); f32 random, or the dryrun's bf16 ones."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jparams = jmoe.init_moe_params(jax.random.key(seed), 2 * EP, D_MODEL, D_FF, jdt)
    if dtype == "float32":
        rng = np.random.default_rng(seed)
        x, target = (rng.normal(size=(8, D_MODEL)).astype(np.float32) for _ in range(2))
    else:
        x = target = np.ones((8, D_MODEL), np.float32)
    tree = {k: np.asarray(v, np.float32) for k, v in jparams.items()}
    return ({"kind": "moe_step", "expert_shape": _expert_mesh_shape(world),
             "n_experts": 2 * EP, "d_model": D_MODEL, "d_ff": D_FF, "lr": LR,
             "tree": dict(tree, dtype=dtype), "x": x, "target": target, "steps": steps},
            (jparams, x, target, jdt, steps))


def _cases(world):
    cases, refs = {}, {}
    for name, dtype, seed, single in (("moe8_f32_sgd", "float32", 5, False),
                                      ("moe8_bf16_sgd", "bfloat16", 6, True)):
        cfg = torch_mesh_ranks.config(dict(MOE8, dtype=dtype))
        jparams = jprobe.init_params(_jax_cfg(cfg), jax.random.key(seed))
        batches = [np.random.default_rng(seed).integers(0, cfg.vocab, (8, 16))]
        cases[name] = {"kind": "sgd", "fields": dict(MOE8, dtype=dtype), "lr": LR,
                       "tree": jax.tree.map(np.asarray, jparams), "batches": batches,
                       "single": single}
        refs[name] = (cfg, jparams, batches)
    cases["moe_step_f32"], refs["moe_step_f32"] = _moe_step_case("float32", 7, 3, world)
    cases["moe_step_bf16_ones"], refs["moe_step_bf16_ones"] = _moe_step_case(
        "bfloat16", 1, 1, world)
    return cases, refs


@pytest.fixture(scope="module")
def runs():
    out = {}
    for shape, (n, m) in SHAPES.items():
        cases, refs = _cases(n * m)
        out[shape] = (run_ranks(torch_mesh_ranks.train_cases, n * m, backend="gloo",
                                args=((n, m), cases), timeout_s=SPAWN_TIMEOUT_S), refs)
    return out


def _reference_mesh(shape, axes=("data", "model")):
    devices = jax.devices("cpu")
    if shape == "2x2":
        return Mesh(np.array(devices[:4]).reshape(2, 2), axes)
    if axes == ("data", "model"):
        return jmesh.build_mesh(devices[:2])
    return Mesh(np.array(devices[:2]).reshape(_expert_mesh_shape(2)), axes)


def _leaves(tree):
    top = [tree[k] for k in sorted(tree) if k != "blocks"]
    return top + [blk[k] for blk in tree["blocks"] for k in sorted(blk)]


def _names(tree):
    top = [k for k in sorted(tree) if k != "blocks"]
    return top + [f"blocks[{i}].{k}" for i, blk in enumerate(tree["blocks"]) for k in sorted(blk)]


@pytest.mark.parametrize("shape", list(SHAPES))
def test_moe8_flagship_sgd_matches_reference(runs, shape):
    """f32, the order of the sums only: the loss within 2e-6 and every
    gathered leaf within 1e-6, as the one-device MoE steps are held
    (test_torch_train_step). The routing agrees, or the outputs would not."""
    results, refs = runs[shape]
    cfg, jparams, batches = refs["moe8_f32_sgd"]
    mesh, jcfg = _reference_mesh(shape), _jax_cfg(cfg)
    params, loss = jts.make_train_step(mesh, jcfg, LR)(
        jts.shard_params(jparams, mesh, jcfg), jnp.asarray(batches[0], jnp.int32))
    want = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    got = results[0]["moe8_f32_sgd"]
    assert got["losses"][0] == pytest.approx(float(loss), abs=2e-6)
    for name, g, w in zip(_names(want), _leaves(got["params"]), _leaves(want), strict=True):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_moe8_bf16_step_matches_the_one_device_step(runs, shape):
    """bf16, the sharded step against the port's one-device step on the
    same full params: the combine's sum over "model" adds exact zeros
    (each token's expert sits on one rank), but wo's partial products are
    summed in bf16 and so are the data shards' grads; each new weight
    within 1 bf16 ulp of its leaf's max |value| (2^-7 of it) and the loss
    within 1e-3, as the dense bf16 case (test_torch_tp_train_step)."""
    results, _ = runs[shape]
    got = results[0]["moe8_bf16_sgd"]
    single = got["single"]
    assert abs(got["losses"][0] - single["loss"]) < 1e-3
    for name, g, w in zip(_names(single["params"]), _leaves(got["params"]),
                          _leaves(single["params"]), strict=True):
        np.testing.assert_allclose(g, w, rtol=0, atol=2**-7 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_moe8_experts_split_over_model(runs, shape):
    """Each rank holds E/tp experts of w1 and w2 and the whole router."""
    results, refs = runs[shape]
    cfg = refs["moe8_f32_sgd"][0]
    n_model = SHAPES[shape][1]
    e = cfg.n_experts // n_model
    qkv = (cfg.n_heads + 2 * cfg.kv_heads) * cfg.d_head // n_model
    block = {"ln1": (cfg.d_model,), "ln2": (cfg.d_model,),
             "router": (cfg.d_model, cfg.n_experts), "w1": (e, cfg.d_model, cfg.d_ff),
             "w2": (e, cfg.d_ff, cfg.d_model), "wo": (cfg.d_model // n_model, cfg.d_model),
             "wqkv": (cfg.d_model, qkv)}
    want = [(cfg.vocab, cfg.d_model)] + [block[k] for _ in range(cfg.n_layers)
                                         for k in sorted(block)]
    for result in results:
        assert result["moe8_f32_sgd"]["shapes"] == want


@pytest.mark.parametrize("shape", list(SHAPES))
def test_moe8_collectives_and_replicas(runs, shape):
    """make_train_step's formula for an MoE config: 4 a block over
    "model"; over "data" a gradient sum a leaf, the loss and each block's
    routed fractions. Every rank's gathered params are bit-equal."""
    results, refs = runs[shape]
    cfg, jparams, _ = refs["moe8_f32_sgd"]
    n_data, n_model = SHAPES[shape]
    n_leaves = len(jax.tree.leaves(jparams))
    rows, seq = 8 // n_data, 16
    calls = {"model": 4 * cfg.n_layers if n_model > 1 else 0,
             "data": n_leaves + 1 + cfg.n_layers if n_data > 1 else 0}
    for result in results:
        shard_bytes = sum(int(np.prod(s)) * 4 for s in result["moe8_f32_sgd"]["shapes"])
        nbytes = {"model": calls["model"] * rows * seq * cfg.d_model * 4,
                  "data": shard_bytes + 4 + cfg.n_layers * cfg.n_experts * 4
                  if n_data > 1 else 0}
        assert result["moe8_f32_sgd"]["counts"] == {"calls": calls, "bytes": nbytes}
        for g, w in zip(_leaves(result["moe8_f32_sgd"]["params"]),
                        _leaves(results[0]["moe8_f32_sgd"]["params"]), strict=True):
            np.testing.assert_array_equal(g, w)


def _reference_moe_steps(shape, jparams, x, target, jdt, steps):
    mesh = _reference_mesh(shape, ("data", "expert"))
    params = jmoe.shard_moe_params(jparams, mesh)
    step = jmoe.make_moe_step(mesh, 2 * EP, D_MODEL, D_FF, lr=LR)
    xs = [jax.device_put(jnp.asarray(a, jdt), NamedSharding(mesh, P("data", None)))
          for a in (x, target)]
    losses, trees = [], []
    for _ in range(steps):
        params, loss = step(params, *xs)
        losses.append(float(loss))
        trees.append({k: np.asarray(v, np.float32) for k, v in params.items()})
    return losses, trees


# (loss atol, params atol as a share of each leaf's max |value|):
# test_torch_moe's one-device make_moe_step tolerances. f32: summation
# order. bf16: a weight can land one ulp apart after the update's rounding,
# 2 ulps of the leaf's max.
MOE_STEP_TOL = {"moe_step_f32": (1e-6, 1e-6), "moe_step_bf16_ones": (1e-4, 2 * 2**-8)}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("name", list(MOE_STEP_TOL))
def test_make_moe_step_matches_reference(runs, shape, name):
    results, refs = runs[shape]
    jparams, x, target, jdt, steps = refs[name]
    want_losses, want = _reference_moe_steps(shape, jparams, x, target, jdt, steps)
    got = results[0][name]
    loss_atol, of_max = MOE_STEP_TOL[name]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=0, atol=loss_atol)
    for i, (g_tree, w_tree) in enumerate(zip(got["params"], want, strict=True)):
        for key, w in w_tree.items():
            np.testing.assert_allclose(g_tree[key], w, rtol=0, atol=of_max * np.abs(w).max(),
                                       err_msg=f"step {i} {key}")
    for result in results[1:]:
        assert result[name]["losses"] == got["losses"]


@pytest.mark.parametrize("shape", list(SHAPES))
def test_make_moe_step_collectives(runs, shape):
    """make_moe_step's docstring: 1 over "expert" (the combine), 5 over
    "data" (the routed fractions, three gradient sums, the loss)."""
    results, _ = runs[shape]
    n_data, n_expert = _expert_mesh_shape(SHAPES[shape][0] * SHAPES[shape][1])
    want = {"data": 5 if n_data > 1 else 0, "expert": 1 if n_expert > 1 else 0}
    for result in results:
        assert result["moe_step_f32"]["counts"]["calls"] == want
