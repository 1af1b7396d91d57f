"""The port's multichip dryrun (``entry.dryrun_multichip``) on the CPU.

``dryrun_multichip(4, device="cpu", backend="gloo")`` runs whole, as the
reference's ``dryrun_multichip`` does on its virtual devices: the dp x tp,
MoE, expert-parallel, dp x sp, ring and pipeline sections on 4 gloo ranks,
then the stretch over the H100 plan (16 ranks on a (2, 8) (data, model)
mesh). Where the reference's seq section fails (6 devices: 16 tokens do
not split over its seq axis of 3), the port's seq mesh holds and the
sections run. The stretch's step is held against the reference's
``make_train_step`` on its 8 virtual devices as (2, 4), in f32: the mesh's
layout does not change GSPMD's result.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from gpumounter_tpu.models import probe as jprobe
from gpumounter_tpu.parallel import train_step as jts
from gpumounter_tpu_torch import entry
from gpumounter_tpu_torch.parallel.launch import run_ranks
from gpumounter_tpu_torch.models.probe import init_params
from gpumounter_tpu_torch.parallel.train_step import tree_leaves

import torch_mesh_ranks
from test_torch_probe import _jax_cfg

SPAWN_TIMEOUT_S = 300.0
NO_LAUNCHES = dict.fromkeys(("flash_fwd", "dq", "dkv"), 0)
# The stretch against the reference, f32: the sums' order only.
STRETCH_ATOL = 1e-5


@pytest.fixture(scope="module")
def dryrun():
    return entry.dryrun_multichip(4, device="cpu", backend="gloo", timeout_s=SPAWN_TIMEOUT_S)


def test_dryrun_runs_every_section_on_four_ranks(dryrun):
    assert dryrun["seq_shape"] == (2, 2) and dryrun["pipe_stages"] == 4
    sections = dryrun["sections"]
    assert [r["rank"] for r in sections] == [0, 1, 2, 3]
    for r in sections:
        tp, seq, pipe = r["tp"], r["seq"], r["pipeline"]
        assert tp["max_grad_err"] < entry.TRAIN_GRAD_ATOL
        assert np.isfinite([tp["loss"], tp["moe_loss"], *tp["moe_step_losses"]]).all()
        assert tp["heads"] == [(16 // 4, 8 // 4)] * 2  # mesh_shape_for(4): (1, 4)
        assert seq["loss_err"] < entry.SHARDED_LOSS_ATOL
        assert max(seq["ring_err"], seq["ring_flash_err"]) < 5e-2
        assert pipe["loss_err"] < entry.SHARDED_LOSS_ATOL and pipe["gpipe_err"] <= 1e-6
        assert pipe["n_micro"] == 4
        assert pipe["bubble"]["interleaved"] < pipe["bubble"]["gpipe"]
        # On the CPU the plain attention runs: no kernel launches.
        assert tp["launches"] == seq["launches"] == pipe["launches"] == NO_LAUNCHES
    for part, key in (("tp", "loss"), ("seq", "loss"), ("pipeline", "loss")):
        assert len({r[part][key] for r in sections}) == 1
    assert all(t > 0 for t in dryrun["seconds"].values())


def test_dryrun_stretch_lays_sixteen_ranks_out_by_the_h100_plan(dryrun):
    """Hosts on data, a host's 8 GPUs on model: each rank holds 2 of 16 q
    heads and 1 of 8 kv heads; one step's collectives are the dp x tp
    formula's (no weight gathered), its loss that of one process."""
    plan = dryrun["plan"]
    assert (plan.num_hosts, plan.gpus_per_host) == (2, 8)
    stretch = dryrun["stretch"]
    assert [(r["coords"]["data"], r["coords"]["model"]) for r in stretch] == [
        (d, m) for d in range(2) for m in range(8)]
    cfg = entry._dryrun_config(torch.device("cpu"))
    for r in stretch:
        assert r["loss_err"] < entry.SHARDED_LOSS_ATOL and r["launches"] == NO_LAUNCHES
        calls = r["collectives"]["calls"]
        assert calls["model"] == 4 * cfg.n_layers
        # one gradient sum a leaf and the loss
        assert calls["data"] == len(tree_leaves(init_params(cfg, torch.Generator(), "cpu"))) + 1
    assert len({r["loss"] for r in stretch}) == 1


def _reference_seq_shape(n):
    """The reference's seq mesh (__graft_entry__.py:207)."""
    dsp = 2 if n % 2 == 0 and n >= 4 else 1
    return dsp, n // dsp


@pytest.mark.parametrize("n", range(1, 17))
def test_seq_mesh_is_the_reference_s_where_that_splits_sixteen_tokens(n):
    got = entry.seq_mesh_shape(n)
    assert got[0] * got[1] == n and 16 % got[1] == 0
    want = _reference_seq_shape(n)
    if 16 % want[1] == 0:
        assert got == want
    else:  # the reference's section fails here; the largest seq axis that fits
        assert got[1] == max(s for s in range(1, n + 1) if n % s == 0 and 16 % s == 0)


def test_dryrun_sections_run_on_six_ranks_where_the_reference_fails():
    """n 6: the reference's seq mesh is (2, 3), and 16 tokens do not split
    over 3. The port's is (3, 2), on the check batch's first 6 rows (its
    tp mesh (3, 2) takes the same rows), and every section passes."""
    assert _reference_seq_shape(6) == (2, 3) and entry.seq_mesh_shape(6) == (3, 2)
    results = run_ranks(torch_mesh_ranks.dryrun_sections_rank, 6, backend="gloo",
                        args=(6,), timeout_s=SPAWN_TIMEOUT_S)
    for r in results:
        assert r["seq"]["loss_err"] < entry.SHARDED_LOSS_ATOL
        assert r["tp"]["max_grad_err"] < entry.TRAIN_GRAD_ATOL
        assert (r["pipeline"] is None) == (r["rank"] >= 4)
    assert len({r["seq"]["loss"] for r in results}) == 1


def test_stretch_step_matches_the_reference():
    """The stretch's config in f32, the reference's init_params(key(2))
    weights: one step on the (2, 8) mesh of 16 gloo ranks against the
    reference's make_train_step on its 8 virtual devices as (2, 4)."""
    cfg = dataclasses.replace(entry._dryrun_config(torch.device("cpu")), dtype=torch.float32)
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["dtype"] = "float32"
    jcfg = _jax_cfg(cfg)
    jparams = jprobe.init_params(jcfg, jax.random.key(entry.STRETCH["SEED"]))
    tokens = entry.check_tokens(cfg).numpy()
    cases = {"f32": {"fields": fields, "tree": jax.tree.map(np.asarray, jparams),
                     "tokens": tokens}}
    results = run_ranks(torch_mesh_ranks.stretch_rank, 16, backend="gloo", args=(cases,),
                        timeout_s=SPAWN_TIMEOUT_S)
    mesh = Mesh(np.array(jax.devices("cpu")[:8]).reshape(2, 4), ("data", "model"))
    params = jts.shard_params(jparams, mesh, jcfg)
    new, loss = jts.make_train_step(mesh, jcfg)(params, jnp.asarray(tokens, jnp.int32))
    want = jax.tree.map(lambda a: np.asarray(a, np.float32), new)
    for r in results:
        got = r["f32"]
        assert abs(got["loss"] - float(loss)) < STRETCH_ATOL
        assert abs(got["loss_unsharded"] - float(jprobe.loss_fn(
            jparams, jnp.asarray(tokens, jnp.int32), jcfg))) < STRETCH_ATOL
        top = sorted(k for k in want if k != "blocks")
        for key in top:
            np.testing.assert_allclose(got["params"][key], want[key], rtol=0, atol=STRETCH_ATOL)
        for g, w in zip(got["params"]["blocks"], want["blocks"], strict=True):
            for key in w:
                np.testing.assert_allclose(g[key], w[key], rtol=0, atol=STRETCH_ATOL,
                                           err_msg=key)
