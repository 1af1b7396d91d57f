"""The port's pipelines against the reference's on the CPU.

The reference runs ``pipeline_apply`` and ``make_pipeline_train_step``
under ``shard_map`` on a ("pipe",) mesh of 4 virtual CPU devices
(``tests/conftest.py``; the probe with ``attn_backend="xla"``). The port
runs the same stages, weights and tokens on 4 gloo ranks, one spawn with
every case inside it (``torch_mesh_ranks.pipeline_cases``); each rank
returns its own block of the stages, which the tests join along the pipe
axis. Both schedules: GPipe (v 1) and interleaved (v 2). f32 throughout.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh as JaxMesh

from gpumounter_tpu.models import probe as jprobe
from gpumounter_tpu.parallel import pipeline_train as jpt
from gpumounter_tpu.parallel.pipeline import pipeline_apply as jax_pipeline_apply
from gpumounter_tpu.parallel.pipeline import schedule_info as jax_schedule_info
from gpumounter_tpu.parallel.pipeline import shard_stage_params as jax_shard_stage_params
from gpumounter_tpu_torch.models.probe import TransformerConfig
from gpumounter_tpu_torch.parallel.launch import run_ranks
from gpumounter_tpu_torch.parallel.mesh import Mesh
from gpumounter_tpu_torch.parallel.pipeline import pipeline_apply, schedule_info
from gpumounter_tpu_torch.parallel.pipeline_train import (make_pipeline_train_step,
                                                          to_pipeline_params)
from gpumounter_tpu_torch.weights import params_from_jax

import torch_mesh_ranks
from test_torch_probe import _jax_cfg

SPAWN_TIMEOUT_S = 180.0  # its own limit: a hung rank fails this module only
N_STAGES = 4
PROBE = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, max_len=16, n_kv_heads=2, rope=True,
             dtype="float32")
LR = 0.1
ATOL = 1e-5


def _apply_case(n_virtual):
    rng = np.random.default_rng(n_virtual)
    lead = (N_STAGES,) if n_virtual == 1 else (N_STAGES, n_virtual)
    w = (np.eye(16) * 0.9 + rng.normal(size=lead + (16, 16)) * 0.1).astype(np.float32)
    x = rng.normal(size=(8, 16)).astype(np.float32)
    return {"kind": "apply", "w": w, "x": x, "n_micro": 4, "n_virtual": n_virtual}


def _train_case(n_virtual, seed):
    fields = dict(PROBE, n_layers=N_STAGES * n_virtual)
    cfg = torch_mesh_ranks.config(fields)
    jparams = jprobe.init_params(_jax_cfg(cfg), jax.random.key(seed))
    rng = np.random.default_rng(100 + seed)
    return {"kind": "train", "fields": fields, "tree": jax.tree.map(np.asarray, jparams),
            "batches": [rng.integers(0, cfg.vocab, (8, 8)) for _ in range(2)],
            "n_micro": 4, "n_virtual": n_virtual, "lr": LR}


CASES = {"apply_gpipe": _apply_case(1), "apply_interleaved": _apply_case(2),
         "train_gpipe": _train_case(1, 0), "train_interleaved": _train_case(2, 1)}


@pytest.fixture(scope="module")
def runs():
    return run_ranks(torch_mesh_ranks.pipeline_cases, N_STAGES, backend="gloo",
                     args=(CASES,), timeout_s=SPAWN_TIMEOUT_S)


def _jax_mesh():
    return JaxMesh(np.array(jax.devices("cpu")[:N_STAGES]), ("pipe",))


@pytest.mark.parametrize("name", ["apply_gpipe", "apply_interleaved"])
def test_pipeline_apply_matches_reference(runs, name):
    """The output on every rank, and the gradients of sum(y²) in the stages
    (each rank's block) and in x (whole on every rank: f's backward)."""
    case = CASES[name]
    mesh = _jax_mesh()

    def fn(w, x):
        return jax_pipeline_apply({"w": w}, x, mesh, lambda p, a: jnp.tanh(a @ p["w"]),
                                  n_micro=case["n_micro"], n_virtual=case["n_virtual"])

    w = jax_shard_stage_params({"w": jnp.asarray(case["w"])}, mesh)["w"]
    y, vjp = jax.vjp(jax.jit(fn), w, jnp.asarray(case["x"]))
    gw, gx = vjp(2 * y)
    for result in runs:
        np.testing.assert_allclose(result[name]["y"], np.asarray(y), rtol=0, atol=ATOL)
        np.testing.assert_allclose(result[name]["gx"], np.asarray(gx), rtol=0, atol=ATOL)
    got_gw = np.concatenate([r[name]["gw"] for r in runs])
    np.testing.assert_allclose(got_gw, np.asarray(gw), rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", ["apply_gpipe", "apply_interleaved"])
def test_pipeline_apply_shifts_once_a_tick(runs, name):
    """ticks − 1 shifts forward and as many backward (the last tick's is left
    out), each of one microbatch's activation; f's all-reduce of x's
    gradient and g's of the output."""
    case = CASES[name]
    ticks = schedule_info(case["n_micro"], N_STAGES, case["n_virtual"])["ticks"]
    act = case["x"].nbytes // case["n_micro"]
    for result in runs:
        assert result[name]["counts"] == {"calls": {"pipe": 2 * (ticks - 1) + 2},
                                          "bytes": {"pipe": 2 * (ticks - 1) * act
                                                    + 2 * case["x"].nbytes}}


@pytest.mark.parametrize("name", ["train_gpipe", "train_interleaved"])
def test_pipeline_train_step_matches_reference(runs, name):
    case = CASES[name]
    cfg = torch_mesh_ranks.config(case["fields"])
    jcfg, mesh, v = _jax_cfg(cfg), _jax_mesh(), case["n_virtual"]
    params = jpt.shard_pipeline_params(jpt.to_pipeline_params(
        jax.tree.map(jnp.asarray, case["tree"]), N_STAGES, v), mesh)
    step = jpt.make_pipeline_train_step(mesh, jcfg, case["n_micro"], LR, n_virtual=v)
    losses = []
    for tokens in case["batches"]:
        params, loss = step(params, jnp.asarray(tokens, jnp.int32))
        losses.append(float(loss))
    for result in runs:
        np.testing.assert_allclose(result[name]["losses"], losses, rtol=0, atol=1e-6)
        for key in ("embed",):
            np.testing.assert_allclose(result[name]["params"][key], np.asarray(params[key]),
                                       rtol=0, atol=ATOL, err_msg=key)
    for key, want in params["stages"].items():
        got = np.concatenate([r[name]["params"]["stages"][key] for r in runs])
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL, err_msg=key)


def test_every_rank_ends_with_the_same_embedding(runs):
    for name in ("train_gpipe", "train_interleaved"):
        for result in runs[1:]:
            assert result[name]["losses"] == runs[0][name]["losses"]
            np.testing.assert_array_equal(result[name]["params"]["embed"],
                                          runs[0][name]["params"]["embed"])


@pytest.mark.parametrize("n_virtual", [1, 2])
def test_to_pipeline_params_matches_reference(n_virtual):
    cfg = torch_mesh_ranks.config(dict(PROBE, rope=False, n_layers=N_STAGES * n_virtual))
    jparams = jprobe.init_params(_jax_cfg(cfg), jax.random.key(7))
    want = jpt.to_pipeline_params(jparams, N_STAGES, n_virtual)
    got = to_pipeline_params(params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu"),
                             N_STAGES, n_virtual)
    assert sorted(got) == sorted(want) == ["embed", "pos", "stages"]
    assert sorted(got["stages"]) == sorted(want["stages"])
    for key in want["stages"]:
        np.testing.assert_array_equal(got["stages"][key].numpy(), np.asarray(want["stages"][key]))


@pytest.mark.parametrize("m,p,v", [(4, 4, 1), (4, 4, 2), (8, 2, 3), (1, 1, 1), (6, 3, 2)])
def test_schedule_info_matches_reference(m, p, v):
    assert schedule_info(m, p, v) == jax_schedule_info(m, p, v)


def _pipe_mesh():
    """Rank 0's Mesh of a ("pipe",) axis of 4; the refusals raise before
    any collective, so no process group is needed."""
    return Mesh(("pipe",), (N_STAGES,), 0, {}, torch.device("cpu"))


def _both_raise(port, reference):
    with pytest.raises(ValueError) as want:
        reference()
    with pytest.raises(ValueError) as got:
        port()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("change,n_micro", [
    (dict(n_layers=6), 4),          # n_layers not divisible by P·v
    (dict(), 2),                    # n_micro < stages: the bubble numbers
    (dict(n_experts=4), 4),         # MoE
    (dict(attn_parallel="seq"), 4),  # the seq layout
])
def test_pipeline_train_refusals_match_reference(change, n_micro):
    cfg = dataclasses.replace(torch_mesh_ranks.config(dict(PROBE, n_layers=8)), **change)
    _both_raise(lambda: make_pipeline_train_step(_pipe_mesh(), cfg, n_micro, n_virtual=2),
                lambda: jpt.make_pipeline_train_step(_jax_mesh(), _jax_cfg(cfg), n_micro,
                                                     n_virtual=2))


@pytest.mark.parametrize("batch,n_micro,n_virtual", [(6, 4, 1), (8, 2, 2)])
def test_pipeline_apply_refusals_match_reference(batch, n_micro, n_virtual):
    """A batch that does not split into the microbatches; an interleaved
    schedule whose microbatches do not divide by the stages."""
    lead = (1,) if n_virtual == 1 else (1, n_virtual)
    x = np.zeros((batch, 16), np.float32)
    _both_raise(
        lambda: pipeline_apply({"w": torch.zeros(lead + (16, 16))}, torch.from_numpy(x),
                               _pipe_mesh(), lambda p, a: a, n_micro=n_micro,
                               n_virtual=n_virtual),
        lambda: jax_pipeline_apply({"w": jnp.zeros((N_STAGES,) + lead[1:] + (16, 16))},
                                   jnp.asarray(x), _jax_mesh(), lambda p, a: a,
                                   n_micro=n_micro, n_virtual=n_virtual))


def test_a_stage_leaf_of_one_dim_is_refused_where_the_reference_raises_index_error():
    """The reference's leading-shape check reads shape[1] of every stage
    leaf, so a 1-D leaf under the interleaved schedule raises IndexError
    (ADVICE.md; gpumounter_tpu/parallel/pipeline.py:161-165). The port
    raises the reference's ValueError, naming the shape."""
    with pytest.raises(IndexError):
        jax_pipeline_apply({"b": jnp.zeros((N_STAGES,))}, jnp.zeros((8, 16)), _jax_mesh(),
                           lambda p, a: a, n_micro=4, n_virtual=2)
    with pytest.raises(ValueError, match=r"stage param leaf has leading shape \(4,\), "
                                         r"expected \(4, 2\)"):
        pipeline_apply({"b": torch.zeros((1,))}, torch.zeros((8, 16)), _pipe_mesh(),
                       lambda p, a: a, n_micro=4, n_virtual=2)


@pytest.mark.parametrize("n_stages", [1, 3])
def test_pipeline_checks_where_the_dryrun_fails(n_stages):
    """The reference's pipeline section fails below 2 devices and at 3,
    where its n_micro 4 does not divide by 3 stages (ADVICE.md;
    __graft_entry__.py:313-315). The port's pipeline_checks skips the
    interleaved section below 2 stages and takes n_micro the least
    multiple of the stage count that is >= 4 (6 for 3 stages)."""
    results = run_ranks(torch_mesh_ranks.pipeline_checks_rank, n_stages, backend="gloo",
                        timeout_s=SPAWN_TIMEOUT_S)
    for result in results:
        assert result["gpipe_err"] <= 1e-6
        if n_stages == 1:
            assert "loss" not in result
        else:
            assert result["n_micro"] == 6 and result["loss_err"] < 1e-2
