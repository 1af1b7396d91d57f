"""The mesh-growing hot-add against the reference, on the CPU.

The reference trains on a (1, 2) mesh of the virtual CPU devices of
``tests/conftest.py`` with ``make_train_step_optax`` and
``optax.adamw(1e-3, weight_decay=1e-4)``, packs params and optimizer
state, restores them onto a grown mesh with ``HotResumable.restore(mesh,
specs)`` and takes more steps: (1, 4), ``mesh_shape_for(4)`` as its own
``test_hot_resume_grows_mesh`` builds it, and (2, 2), which grows "data"
too. The port runs the same weights (``params_from_jax``) and batches in
two worlds of gloo ranks: world A (2 ranks, ``entry.grow_pack``) packs and
saves, world B (4 ranks, ``entry.grow_restore``) loads and restores its
shards, which it holds bit-equal to ``shard_params`` of what was packed
(and raises otherwise), and steps on. One spawn per world shape with every
case inside it (``torch_mesh_ranks.grow_world_a`` / ``grow_world_b``).
f32 throughout: the two differ only in the order of the sums.
"""

from __future__ import annotations

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from gpumounter_tpu.jaxside.resume import HotResumable as JaxResumable
from gpumounter_tpu.models import probe as jprobe
from gpumounter_tpu.parallel import mesh as jmesh
from gpumounter_tpu.parallel import train_step as jts
from gpumounter_tpu_torch import entry
from gpumounter_tpu_torch.models.probe import TransformerConfig, init_params
from gpumounter_tpu_torch.parallel import mesh as tmesh
from gpumounter_tpu_torch.parallel.launch import run_ranks
from gpumounter_tpu_torch.parallel.train_step import (param_specs, shard_params, tree_leaves,
                                                      tree_map)
from gpumounter_tpu_torch.torchside.resume import (HotResumable, optimizer_state_specs,
                                                   optimizer_state_tree)

import torch_mesh_ranks
from test_torch_probe import MOE_FLAGSHIP, _jax_cfg
from test_torch_tp_train_step import FLAGSHIP

SPAWN_TIMEOUT_S = 240.0
OLD_SHAPE = (1, 2)
NEW_SHAPES = {"1x4": (1, 4), "2x2": (2, 2)}
STEPS = (2, 2)
CASES = {"dense": dict(FLAGSHIP, dtype="float32"), "moe": dict(MOE_FLAGSHIP, dtype="float32")}
ADAMW = optax.adamw(entry.GROW_ADAMW["lr"], weight_decay=entry.GROW_ADAMW["weight_decay"])
# Against the reference, f32. Losses: the sums' order only (the sharded
# AdamW test's 2e-6 in test_torch_tp_train_step, within the 1e-5 asked of
# the grown world). Params and moments after AdamW steps: Adam divides
# each gradient by sqrt(v), so where a gradient is near 0 its f32 rounding
# differences reach the update whole; 1e-4, as test_torch_tp_train_step's
# AdamW test allows.
LOSS_ATOL = 1e-5
ADAMW_ATOL = 1e-4


def _cases():
    cases, refs = {}, {}
    for seed, (name, fields) in enumerate(CASES.items()):
        cfg = torch_mesh_ranks.config(fields)
        jparams = jprobe.init_params(_jax_cfg(cfg), jax.random.key(seed))
        rng = np.random.default_rng(500 + seed)
        batches = [rng.integers(0, cfg.vocab, entry.DRYRUN_TOKENS) for _ in range(sum(STEPS))]
        cases[name] = {"fields": fields, "tree": jax.tree.map(np.asarray, jparams),
                       "before": batches[:STEPS[0]], "after": batches[STEPS[0]:]}
        refs[name] = (cfg, jparams, batches)
    return cases, refs


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """(world A's per-rank results, {shape: world B's}, reference inputs)."""
    cases, refs = _cases()
    root = str(tmp_path_factory.mktemp("grow"))
    old = run_ranks(torch_mesh_ranks.grow_world_a, 2, backend="gloo",
                    args=(OLD_SHAPE, cases, root), timeout_s=SPAWN_TIMEOUT_S)
    new = {shape: run_ranks(torch_mesh_ranks.grow_world_b, 4, backend="gloo",
                            args=(dims, cases, root), timeout_s=SPAWN_TIMEOUT_S)
           for shape, dims in NEW_SHAPES.items()}
    return old, new, refs


def _reference_mesh(shape):
    devices = jax.devices("cpu")
    if shape == "2x2":
        return Mesh(np.array(devices[:4]).reshape(2, 2), ("data", "model"))
    return jmesh.build_mesh(devices[:4])


def _numpy(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


_REFERENCE = {}


def _reference(name, refs):
    """The reference's grow: world A's losses and packed (params, moments),
    and per grown mesh its restored initial weights, the losses and params
    after the steps there; cached per case."""
    if name in _REFERENCE:
        return _REFERENCE[name]
    cfg, jparams, batches = refs[name]
    jcfg = _jax_cfg(cfg)
    mesh_a = jmesh.build_mesh(jax.devices("cpu")[:2])
    init_fn, step_fn = jts.make_train_step_optax(mesh_a, jcfg, ADAMW)
    params = jts.shard_params(jparams, mesh_a, jcfg)
    state = init_fn(params)
    losses_a = []
    for tokens in batches[:STEPS[0]]:
        params, state, loss = step_fn(params, state, jnp.asarray(tokens, jnp.int32))
        losses_a.append(float(loss))
    snapshot = JaxResumable.pack(params, state)
    adam = snapshot.host_state[1][0]
    out = {"losses": losses_a, "params": _numpy(snapshot.host_state[0]),
           "exp_avg": _leaves(_numpy(adam.mu)), "exp_avg_sq": _leaves(_numpy(adam.nu))}
    pspecs = jts.param_specs(jcfg)
    param_tree = jax.tree.structure(params)

    def is_params(x):
        return jax.tree.structure(x) == param_tree

    state_specs = jax.tree.map(lambda x: pspecs if is_params(x) else P(), state,
                               is_leaf=is_params)
    initial = JaxResumable.pack(jts.shard_params(jparams, mesh_a, jcfg))
    for shape in NEW_SHAPES:
        mesh_b = _reference_mesh(shape)
        params_b, state_b = snapshot.restore(mesh_b, specs=(pspecs, state_specs))
        for a, b in zip(jax.tree.leaves(snapshot.host_state),
                        jax.tree.leaves((params_b, state_b)), strict=True):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        (init_b,) = initial.restore(mesh_b, specs=(pspecs,))
        _, step_b = jts.make_train_step_optax(mesh_b, jcfg, ADAMW)
        losses = []
        for tokens in batches[STEPS[0]:]:
            params_b, state_b, loss = step_b(params_b, state_b, jnp.asarray(tokens, jnp.int32))
            losses.append(float(loss))
        out[shape] = {"losses": losses, "params": _numpy(params_b), "initial": _numpy(init_b)}
    _REFERENCE[name] = out
    return out


def _leaves(tree):
    top = [tree[k] for k in sorted(tree) if k != "blocks"]
    return top + [blk[k] for blk in tree["blocks"] for k in sorted(blk)]


@pytest.mark.parametrize("name", list(CASES))
def test_the_old_world_packs_what_the_reference_packs(worlds, name):
    """World A: 2 AdamW steps on (1, 2), then the whole params and both
    moments, gathered through the placement, against the reference's
    pack; every rank packs the same whole state."""
    old, _, refs = worlds
    want = _reference(name, refs)
    got = old[0][name]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0, atol=LOSS_ATOL)
    for g, w in zip(_leaves(got["packed"]["params"]), _leaves(want["params"]), strict=True):
        np.testing.assert_allclose(g, w, rtol=0, atol=ADAMW_ATOL)
    for key in ("exp_avg", "exp_avg_sq"):  # both in tree_leaves order
        for g, w in zip(got["packed"][key], want[key], strict=True):
            np.testing.assert_allclose(g, w, rtol=0, atol=ADAMW_ATOL)
    for other in old[1:]:
        for g, w in zip(_leaves(other[name]["packed"]["params"]),
                        _leaves(got["packed"]["params"]), strict=True):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("shape", list(NEW_SHAPES))
@pytest.mark.parametrize("name", list(CASES))
def test_the_grown_world_steps_as_the_reference_does(worlds, name, shape):
    """World B: its 2 AdamW steps after the restore against the
    reference's on its grown mesh; every rank's losses equal; rank 0's
    first step's update equal to one process's from the same state."""
    _, new, refs = worlds
    want = _reference(name, refs)[shape]
    results = new[shape]
    got = results[0][name]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0, atol=LOSS_ATOL)
    for g, w in zip(_leaves(got["params"]), _leaves(want["params"]), strict=True):
        np.testing.assert_allclose(g, w, rtol=0, atol=ADAMW_ATOL)
    assert all(r[name]["losses"] == got["losses"] for r in results)
    assert got["one_process"]["worst_param"][0] == 0.0
    assert got["one_process"]["loss_err"] < LOSS_ATOL


@pytest.mark.parametrize("shape", list(NEW_SHAPES))
@pytest.mark.parametrize("name", list(CASES))
def test_restored_shards_are_shard_params_and_gather_to_the_reference_s_restore(
        worlds, name, shape):
    """The initial weights packed whole and restored onto the grown mesh:
    every shard bit-equal to shard_params', and the params gathered again
    bit-equal to the reference's restored arrays (grow_restore holds the
    trained state so, and raises otherwise)."""
    _, new, refs = worlds
    want = _reference(name, refs)[shape]["initial"]
    for result in new[shape]:
        assert result[name]["init_shards_equal"]
        for g, w in zip(_leaves(result[name]["init_gathered"]), _leaves(want), strict=True):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", list(CASES))
def test_a_grown_model_axis_holds_whole_q_k_and_v_heads(worlds, name):
    """The trap of the fused wqkv: on the (1, 4) mesh rank r holds its q
    heads' columns, then its k heads', then its v heads', not the r-th
    contiguous quarter (which would hold q columns only)."""
    _, new, refs = worlds
    cfg = refs[name][0]
    h, h_kv, d = cfg.n_heads // 4, cfg.kv_heads // 4, cfg.d_head
    k0, v0 = cfg.n_heads * d, (cfg.n_heads + cfg.kv_heads) * d
    whole = [np.asarray(blk["wqkv"], np.float32) for blk in refs[name][1]["blocks"]]
    for result in new["1x4"]:
        r = result[name]["coords"]["model"]
        for got, w in zip(result[name]["wqkv"], whole, strict=True):
            want = np.concatenate([w[:, r * h * d:(r + 1) * h * d],
                                   w[:, k0 + r * h_kv * d:k0 + (r + 1) * h_kv * d],
                                   w[:, v0 + r * h_kv * d:v0 + (r + 1) * h_kv * d]], axis=1)
            np.testing.assert_array_equal(got, want)
            assert not np.array_equal(got, w[:, r * got.shape[1]:(r + 1) * got.shape[1]])


def test_every_world_orders_the_leaves_alike(worlds):
    """The optimizer's state is keyed by tree_leaves order: it is the same
    in both worlds and on every mesh, and it is the order of the params'
    tree_leaves on one device."""
    old, new, refs = worlds
    for name in CASES:
        cfg = refs[name][0]
        names = old[0][name]["names"]
        assert len(names) == len(tree_leaves(init_params(cfg, torch.Generator(), "cpu")))
        for results in [old, *new.values()]:
            assert all(r[name]["names"] == names for r in results)


def _mesh(shape, rank):
    """A rank's Mesh without process groups: restore runs no collective."""
    return tmesh.Mesh(("data", "model"), shape, rank, {}, torch.device("cpu"))


def test_restore_places_each_leaf_of_params_and_adamw_state():
    """restore(specs, mesh) on each rank of a (2, 2) mesh: every params leaf
    and both moments of each parameter through shard_leaf on the params'
    specs (shard_params), step and param_groups whole; restore(mesh)
    without specs, every leaf whole on the mesh's device."""
    cfg = TransformerConfig(vocab=16, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2, d_ff=8,
                            max_len=8, dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    leaves = tree_leaves(params)
    opt = torch.optim.AdamW(leaves, lr=1e-3)
    for leaf in leaves:
        leaf.grad = torch.randn(leaf.shape, generator=torch.Generator().manual_seed(1))
    opt.step()
    state = HotResumable.pack(params, optimizer_state_tree(opt))
    specs = (param_specs(cfg), optimizer_state_specs(param_specs(cfg)))
    for rank in range(4):
        mesh = _mesh((2, 2), rank)
        got, got_opt = state.restore(specs=specs, mesh=mesh)
        want = shard_params(params, mesh, cfg)
        for g, w in zip(tree_leaves(got), tree_leaves(want), strict=True):
            assert torch.equal(g, w)
        for key in ("exp_avg", "exp_avg_sq"):
            moments = iter([opt.state[leaf][key] for leaf in leaves])
            whole = tree_map(lambda _: next(moments), params)
            for i, w in enumerate(tree_leaves(shard_params(whole, mesh, cfg))):
                assert torch.equal(got_opt["state"][str(i)][key], w)
        for i, leaf in enumerate(leaves):
            assert torch.equal(got_opt["state"][str(i)]["step"], opt.state[leaf]["step"])
        assert got_opt["param_groups"][0]["lr"].item() == 1e-3
    whole, _ = state.restore(mesh=_mesh((2, 2), 3))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(whole), leaves))


def test_pack_and_restore_refuse_specs_without_a_mesh():
    state = HotResumable.pack({"w": torch.ones(2)})
    with pytest.raises(ValueError, match="pass mesh="):
        HotResumable.pack({"w": torch.ones(2)}, specs=({"w": ()},))
    with pytest.raises(ValueError, match="no mesh was given"):
        state.restore("cpu", specs=({"w": ()},))


def test_a_spec_tree_must_name_every_key():
    state = HotResumable.pack({"w": torch.ones(2), "b": torch.ones(2)})
    with pytest.raises(ValueError, match=r"the specs name no \['b'\]"):
        state.restore(specs=({"w": ()},), mesh=_mesh((1, 1), 0))


def test_grow_check_runs_on_the_cpu(tmp_path):
    """The entry point itself, as a user calls it: (1, 2) -> (2, 2) at a
    small dense config; every check inside it raises on failure."""
    cfg = entry.check_config(d_model=64)
    result = entry.grow_check((1, 2), (2, 2), device="cpu", backend="gloo",
                              path=str(tmp_path / "ckpt"), cfg=cfg, timeout_s=SPAWN_TIMEOUT_S)
    assert len(result["old"]) == 2 and len(result["new"]) == 4
    assert all(len(r["losses"]) == 2 and np.isfinite(r["losses"]).all()
               for r in result["old"] + result["new"])
    assert result["new"][0]["one_process"]["worst_param"][0] == 0.0
    times = result["new"][0]["times"]
    assert {k: len(v) for k, v in times.items() if k != "first_step"} == dict.fromkeys(
        ("load", "restore", "optimizer"), entry.GROW_REPEATS)
    assert result["start_s"] > 0
    with pytest.raises(ValueError, match="at least one step"):
        entry.grow_check((1, 2), (2, 2), device="cpu", backend="gloo",
                         path=str(tmp_path / "x"), steps=(0, 2))


def test_grow_checks_grows_dense_and_moe_in_one_pair_of_worlds(tmp_path):
    """``grow_checks`` as the smoke calls it: the dense and the MoE config
    (the expert and router shards through the grow's specs) packed by one
    spawn of 2 ranks and restored by one spawn of 4; each config's checks
    run inside, and each config's results equal its own ``grow_check``'s
    in losses."""
    cfgs = [entry.check_config(d_model=64), entry.check_config(d_model=64, n_experts=4)]
    paths = [str(tmp_path / "dense"), str(tmp_path / "moe")]
    result = entry.grow_checks((1, 2), (2, 2), cfgs, paths, device="cpu", backend="gloo",
                               timeout_s=SPAWN_TIMEOUT_S)
    assert len(result["configs"]) == 2 and result["start_s"] > 0
    for worlds in result["configs"]:
        assert [r["rank"] for r in worlds["old"]] == [0, 1]
        assert [r["rank"] for r in worlds["new"]] == [0, 1, 2, 3]
        assert worlds["new"][0]["one_process"]["loss_err"] < entry.ONE_PROCESS_LOSS_ATOL["MoE"]
    dense, moe = result["configs"]
    assert dense["old"][0]["losses"] != moe["old"][0]["losses"]
    assert any("router" in name for name in moe["new"][0]["names"])
    alone = entry.grow_check((1, 2), (2, 2), device="cpu", backend="gloo",
                             path=str(tmp_path / "alone"), cfg=cfgs[1], timeout_s=SPAWN_TIMEOUT_S)
    assert alone["new"][0]["losses"] == moe["new"][0]["losses"]
    with pytest.raises(ValueError, match="2 configs, 1 checkpoint paths"):
        entry.grow_checks((1, 2), (2, 2), cfgs, paths[:1], device="cpu", backend="gloo")
