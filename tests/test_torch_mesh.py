"""The port's mesh, collectives, tp attention and launcher on the CPU.

The reference's ``mesh_shape_for``, its rank layout
(``np.array(devices).reshape(shape)``) and ``tp_flash_attention`` (with
``backend="xla"``, on the virtual CPU devices of ``tests/conftest.py``)
against the port's, which run as gloo ranks: one spawn per world shape
(4 ranks as 2 x 2, 2 ranks as 1 x 2), every case inside it
(``torch_mesh_ranks.mesh_cases``).
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh as JaxMesh

from gpumounter_tpu.parallel import mesh as jmesh
from gpumounter_tpu.parallel.tp_attention import tp_flash_attention as jax_tp_flash_attention
from gpumounter_tpu.parallel.train_step import param_specs as jax_param_specs
from gpumounter_tpu_torch.models.probe import TransformerConfig, forward, init_params
from gpumounter_tpu_torch.parallel import mesh as tmesh
from gpumounter_tpu_torch.parallel.launch import run_ranks
from gpumounter_tpu_torch.parallel.moe import init_moe_params, make_moe_step, shard_moe_params
from gpumounter_tpu_torch.parallel.tp_attention import shard_heads, tp_flash_attention
from gpumounter_tpu_torch.parallel.train_step import param_specs, shard_params

import torch_mesh_ranks
from test_torch_probe import _jax_cfg

SPAWN_TIMEOUT_S = 120.0  # its own limit: a hung rank fails this module only
SHAPES = {"2x2": (2, 2), "1x2": (1, 2)}
# tp attention: B 2, H 4, H_kv 2 (GQA groups of 2), L 8, D 16, f32.
QKV_SHAPES = ((2, 4, 8, 16), (2, 2, 8, 16), (2, 2, 8, 16))


def _qkv():
    rng = np.random.default_rng(0)
    return [rng.normal(size=s).astype(np.float32) for s in QKV_SHAPES]


@pytest.fixture(scope="module")
def runs():
    return {shape: run_ranks(torch_mesh_ranks.mesh_cases, n * m, backend="gloo",
                             args=((n, m), _qkv()), timeout_s=SPAWN_TIMEOUT_S)
            for shape, (n, m) in SHAPES.items()}


@pytest.mark.parametrize("n", range(1, 17))
def test_mesh_shape_for_matches_reference(n):
    assert tmesh.mesh_shape_for(n) == jmesh.mesh_shape_for(n)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_rank_layout_matches_the_reference_mesh(runs, shape):
    """Rank r sits where device r sits in the reference's
    np.array(devices).reshape(shape); each axis's group holds the ranks
    along it, in axis order."""
    n, m = SHAPES[shape]
    grid = np.arange(n * m).reshape(n, m)
    ref = JaxMesh(np.array(jax.devices("cpu")[:n * m]).reshape(n, m), ("data", "model"))
    assert dict(ref.shape) == {"data": n, "model": m}
    for rank, result in enumerate(runs[shape]):
        d, c = (int(i) for i in np.argwhere(grid == rank)[0])
        assert result["coords"] == {"data": d, "model": c}
        assert result["axis_ranks"] == {"data": grid[:, c].tolist(), "model": grid[d].tolist()}
        assert result["device"] == "cpu"


@pytest.mark.parametrize("shape", list(SHAPES))
def test_f_and_g_gradients(runs, shape):
    """g: the sum over the model axis forward, its gradient passed through
    (2·scale, not 2·n·scale); f: identity forward, the gradients summed.
    torch.distributed.nn.functional.all_reduce all-reduces in its backward
    too: its gradient is 2·n where g's is 2, which is why it is not g."""
    for rank, result in enumerate(runs[shape]):
        n = result["model_size"]
        scale = result["coords"]["model"] + 1
        assert result["g_value"] == [2.0 * n] * 3
        assert result["g_grad"] == [2.0 * scale] * 3
        assert result["f_grad"] == [float(sum(range(1, n + 1)))] * 3
        assert result["library_all_reduce_grad"] == [2.0 * n] * 3


@pytest.mark.parametrize("shape", list(SHAPES))
def test_collectives_are_counted_per_axis(runs, shape):
    """One call each; the bytes are the payload: 5 bf16 reduced, 6 f32
    gathered from each of the data axis's ranks. An axis of size 1 runs
    and counts nothing."""
    n, m = SHAPES[shape]
    for result in runs[shape]:
        assert result["counts"] == {
            "calls": {"data": int(n > 1), "model": int(m > 1)},
            "bytes": {"data": 24 * n if n > 1 else 0, "model": 10 if m > 1 else 0}}


@pytest.mark.parametrize("shape", list(SHAPES))
def test_tp_flash_attention_matches_reference(runs, shape):
    """Each rank's heads of the reference's output (H 4, H_kv 2 split in
    whole GQA groups; causal, window 3), f32: the order of the sums only."""
    n, m = SHAPES[shape]
    mesh = JaxMesh(np.array(jax.devices("cpu")[:n * m]).reshape(n, m), ("data", "model"))
    q, k, v = (jnp.asarray(a) for a in _qkv())
    want = np.asarray(jax_tp_flash_attention(q, k, v, mesh, backend="xla", window=3))
    h = QKV_SHAPES[0][1] // m
    for result in runs[shape]:
        r = result["coords"]["model"]
        np.testing.assert_allclose(result["tp_attention"], want[:, r * h:(r + 1) * h],
                                   rtol=0, atol=1e-6)


def _mesh(n_model, coord=0, axes=("data", "model")):
    """A rank's Mesh without process groups: enough for what raises before
    any collective."""
    return tmesh.Mesh(axes, (1, n_model), coord, {}, torch.device("cpu"))


@pytest.mark.parametrize("h, h_kv", [(3, 3), (4, 1), (6, 3)])
def test_tp_flash_attention_refuses_heads_that_do_not_divide(h, h_kv):
    q = torch.zeros(1, h, 4, 8)
    k = torch.zeros(1, h_kv, 4, 8)
    with pytest.raises(ValueError, match="heads must divide the 'model' axis"):
        tp_flash_attention(q, k, k, _mesh(2))
    jmesh_ = JaxMesh(np.array(jax.devices("cpu")[:2]).reshape(1, 2), ("data", "model"))
    jq, jk = jnp.zeros((1, h, 4, 8)), jnp.zeros((1, h_kv, 4, 8))
    with pytest.raises(ValueError, match="heads must divide the 'model' axis"):
        jax_tp_flash_attention(jq, jk, jk, jmesh_, backend="xla")


def test_shard_heads_takes_this_ranks_heads():
    x = torch.arange(2 * 4 * 3 * 2.0).reshape(2, 4, 3, 2)
    for r in range(2):
        assert torch.equal(shard_heads(x, _mesh(2, r)), x[:, 2 * r:2 * r + 2])
    with pytest.raises(ValueError, match="do not split evenly"):
        shard_heads(torch.zeros(1, 3, 2, 2), _mesh(2))


@pytest.mark.parametrize("fields, match", [
    (dict(d_model=24, n_heads=3), "heads must divide"),
    (dict(d_model=32, n_heads=4, n_kv_heads=1), "heads must divide"),
    (dict(d_model=32, n_heads=4, d_ff=7), "does not split evenly over the 'model' axis"),
    (dict(d_model=32, n_heads=4, n_experts=3), "does not split evenly over the 'model' axis"),
])
def test_shard_params_refuses_uneven_splits(fields, match):
    cfg = TransformerConfig(vocab=16, n_layers=1, max_len=8, dtype=torch.float32,
                            **{"d_ff": 8, **fields})
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match=match):
        shard_params(params, _mesh(2), cfg)


def test_forward_under_a_mesh_refuses_heads_that_do_not_divide():
    cfg = TransformerConfig(vocab=16, d_model=24, n_heads=3, n_layers=1, d_ff=8,
                            max_len=8, dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="heads must divide the 'model' axis"):
        forward(params, torch.zeros((1, 4), dtype=torch.long), cfg, mesh=_mesh(2))


def test_make_moe_step_refuses_other_meshes_and_uneven_experts():
    with pytest.raises(ValueError, match="'data', 'expert'"):
        make_moe_step(4, 8, 8, mesh=_mesh(2))
    with pytest.raises(ValueError, match="do not split evenly"):
        make_moe_step(3, 8, 8, mesh=_mesh(2, axes=("data", "expert")))
    params = init_moe_params(torch.Generator().manual_seed(0), 4, 8, 8, torch.float32, "cpu")
    local = shard_moe_params(params, _mesh(2, 1, ("data", "expert")))
    assert torch.equal(local["w1"], params["w1"][2:]) and torch.equal(
        local["router"], params["router"])


@pytest.mark.parametrize("n_experts", [None, 4])
@pytest.mark.parametrize("rope", [False, True])
def test_param_specs_match_reference(n_experts, rope):
    cfg = TransformerConfig(vocab=16, d_model=32, n_heads=4, n_layers=2, d_ff=8,
                            max_len=8, dtype=torch.float32, rope=rope, n_experts=n_experts)
    want = jax_param_specs(_jax_cfg(cfg))
    got = param_specs(cfg)
    assert set(got) == set(want)
    for key in got:
        if key != "blocks":
            assert got[key] == tuple(want[key]), key
    for g, w in zip(got["blocks"], want["blocks"], strict=True):
        assert {k: tuple(v) for k, v in w.items()} == g


def test_build_mesh_needs_torch_distributed():
    with pytest.raises(RuntimeError, match="init_process_group"):
        tmesh.build_mesh((1, 1), device="cpu")


def test_launcher_names_a_rank_that_raises():
    """Rank 0 may fail too, its barrier broken by rank 1's exit; both are
    named, each with its traceback."""
    with pytest.raises(RuntimeError, match=r"ranks \[(0, )?1\] of 2 failed:(.|\n)*"
                                           r"--- rank 1 ---(.|\n)*fails on purpose"):
        run_ranks(torch_mesh_ranks.fail_on, 2, backend="gloo", args=(1,),
                  timeout_s=SPAWN_TIMEOUT_S)


def test_launcher_names_a_rank_that_hangs():
    with pytest.raises(TimeoutError, match=r"ranks \[(0, )?1\] of 2 gave no result"):
        run_ranks(torch_mesh_ranks.hang_on, 2, backend="gloo", args=(1,), timeout_s=10.0)
