"""The port's dp x sp train steps against the reference's on the CPU.

The reference runs ``make_train_step(mesh, cfg)`` and
``make_train_step_optax`` with ``attn_parallel="seq"`` under GSPMD on the
virtual CPU devices of ``tests/conftest.py`` (``attn_backend="xla"``, so
its ring runs the einsum body), on a 2 x 2 and a 1 x 4 ("data", "seq")
mesh. The port runs the same weights and tokens on 4 gloo ranks of each
shape (``parallel.launch.run_ranks``), one spawn per shape with every case
inside it (``torch_mesh_ranks.seq_train_cases``). f32 throughout: the two
differ in the order of the sums only (the ring's lse merge against the
einsum body's running sums, the loss's per-rank sums).

Every case splits the sequence, so the next-token shift crosses a chunk
border on every rank but the last; the chunk-of-one case leaves each rank
of the 1 x 4 mesh a single position, which the last rank does not score.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh as JaxMesh

from gpumounter_tpu.models import probe as jprobe
from gpumounter_tpu.parallel import train_step as jts
from gpumounter_tpu_torch.entry import SHARDED_LOSS_ATOL, seq_pipeline_check
from gpumounter_tpu_torch.models.probe import TransformerConfig, init_params
from gpumounter_tpu_torch.ops.flash_attention import attention_plain
from gpumounter_tpu_torch.parallel.launch import run_ranks
from gpumounter_tpu_torch.parallel.mesh import Mesh
from gpumounter_tpu_torch.parallel.train_step import loss_and_grads, param_specs

import torch_mesh_ranks
from test_torch_probe import _jax_cfg

SPAWN_TIMEOUT_S = 240.0  # its own limit: a hung rank fails this module only
SHAPES = {"2x2": (2, 2), "1x4": (1, 4)}
SEQ = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_len=16,
           attn_parallel="seq", dtype="float32")
GQA = dict(SEQ, n_kv_heads=2, rope=True)
MOE = dict(GQA, n_experts=4)
ADAMW = dict(lr=1e-2, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
LR = 0.1
LOSS_ATOL, PARAM_ATOL = 1e-6, 1e-5
# Adam divides each grad by sqrt(v): where a grad is near 0 its f32
# rounding differences reach the update whole (test_torch_tp_train_step).
ADAMW_PARAM_ATOL = 1e-4

# name: (config fields, kind, seed, steps, batch (B, L), shapes).
CASES = {
    "gqa_rope_sgd": (GQA, "sgd", 0, 2, (4, 8), list(SHAPES)),
    "moe_sgd": (MOE, "sgd", 1, 2, (4, 8), list(SHAPES)),
    # AdamW, dense on one mesh and MoE on the other: each reference step is
    # one more JAX compile (~4 s here).
    "gqa_rope_adamw": (GQA, "adamw", 2, 2, (4, 8), ["2x2"]),
    "moe_adamw": (MOE, "adamw", 3, 2, (4, 8), ["1x4"]),
    # Learned positions at the chunk's offset; L = 4 over seq 4 is one
    # position a rank.
    "mha_learned_pos_chunk_of_one_sgd": (SEQ, "sgd", 4, 1, (4, 4), ["1x4"]),
}


def _port_cases(shape):
    cases, refs = {}, {}
    for name, (fields, kind, seed, steps, batch, shapes) in CASES.items():
        if shape not in shapes:
            continue
        cfg = torch_mesh_ranks.config(fields)
        jparams = jprobe.init_params(_jax_cfg(cfg), jax.random.key(seed))
        rng = np.random.default_rng(100 + seed)
        batches = [rng.integers(0, cfg.vocab, batch) for _ in range(steps)]
        case = {"kind": kind, "fields": fields, "tree": jax.tree.map(np.asarray, jparams),
                "batches": batches}
        if kind == "sgd":
            case["lr"] = LR
        else:
            case["adamw"] = ADAMW
        cases[name] = case
        refs[name] = (cfg, jparams, batches)
    return cases, refs


@pytest.fixture(scope="module")
def runs():
    """{shape: (per-rank results, reference inputs)}."""
    out = {}
    for shape, (n, m) in SHAPES.items():
        cases, refs = _port_cases(shape)
        out[shape] = (run_ranks(torch_mesh_ranks.seq_train_cases, n * m, backend="gloo",
                                args=((n, m), cases), timeout_s=SPAWN_TIMEOUT_S), refs)
    return out


def _reference(name, shape, refs):
    """(losses, new params as numpy) of the reference's sharded steps."""
    cfg, jparams, batches = refs[name]
    mesh = JaxMesh(np.array(jax.devices("cpu")[:4]).reshape(SHAPES[shape]), ("data", "seq"))
    jcfg = _jax_cfg(cfg)
    params = jts.shard_params(jparams, mesh, jcfg)
    losses = []
    if CASES[name][1] == "sgd":
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


@pytest.mark.parametrize("shape,name", [(s, n) for n, case in CASES.items() for s in case[-1]])
def test_seq_step_matches_reference(runs, shape, name):
    results, refs = runs[shape]
    want_losses, want = _reference(name, shape, refs)
    got = results[0][name]
    atol = PARAM_ATOL if CASES[name][1] == "sgd" else ADAMW_PARAM_ATOL
    np.testing.assert_allclose(got["losses"], want_losses, rtol=0, atol=LOSS_ATOL)
    for leaf_name, g, w in zip(_names(want), _leaves(got["params"]), _leaves(want), strict=True):
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=leaf_name)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_seq_forward_gives_each_rank_its_chunk_of_the_logits(runs, shape):
    """forward under the seq layout on this rank's rows and chunk
    (shard_tokens(..., seq=True)): the ranks' logits, joined over data and
    seq, are the reference's unsharded forward's (f32, 1e-5)."""
    results, refs = runs[shape]
    n_data, n_seq = SHAPES[shape]
    for name in results[0]:
        cfg, jparams, batches = refs[name]
        jcfg = dataclasses.replace(_jax_cfg(cfg), attn_parallel="heads")
        want = np.asarray(jprobe.forward(jparams, jnp.asarray(batches[0], jnp.int32), jcfg))
        rows = [np.concatenate([results[d * n_seq + c][name]["logits"] for c in range(n_seq)],
                               axis=1) for d in range(n_data)]
        np.testing.assert_allclose(np.concatenate(rows), want, rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_every_rank_ends_with_the_same_params(runs, shape):
    """The params are replicated: after the steps every rank's are bit-equal,
    and so are the losses."""
    results, _ = runs[shape]
    first = results[0]
    for rank, other in enumerate(results[1:], start=1):
        for name in first:
            assert other[name]["losses"] == first[name]["losses"], (name, rank)
            for g, w in zip(_leaves(other[name]["params"]), _leaves(first[name]["params"]),
                            strict=True):
                np.testing.assert_array_equal(g, w, err_msg=f"{name} rank {rank}")


@pytest.mark.parametrize("shape", list(SHAPES))
def test_collectives_a_step_follow_the_formula(runs, shape):
    """step_collectives' seq formula, and what it says for the 2 x 2 dense
    case written out: over "seq" the ring's 2·(sp − 1) shifts a block of
    k and v (B/dp, H_kv, L/sp, d_head) and a sum a leaf and of the loss;
    over "data" a sum a leaf and of the loss."""
    results, refs = runs[shape]
    for result in results:
        for name, got in result.items():
            assert got["counts"] == got["counts_formula"], name
    if shape == "2x2":
        cfg, jparams, _ = refs["gqa_rope_sgd"]
        n_leaves = len(jax.tree.leaves(jparams))
        leaf_bytes = sum(a.size * 4 for a in jax.tree.leaves(jparams))
        kv = 2 * 2 * cfg.kv_heads * 4 * cfg.d_head * 4  # k and v of 2 rows, 4 positions
        assert results[0]["gqa_rope_sgd"]["counts"] == {
            "calls": {"data": n_leaves + 1, "seq": n_leaves + 1 + 2 * cfg.n_layers},
            "bytes": {"data": leaf_bytes + 4, "seq": leaf_bytes + 4 + 2 * cfg.n_layers * kv}}


def test_param_specs_replicate_everything_as_the_reference():
    cfg = torch_mesh_ranks.config(MOE)
    want = jts.param_specs(_jax_cfg(cfg))
    got = param_specs(cfg)
    assert all(spec == () for spec in jax.tree.leaves(want, is_leaf=lambda s: isinstance(s, tuple)))
    assert all(set(spec) == {None} for spec in jax.tree.leaves(got, is_leaf=lambda s: isinstance(s, tuple)))


def test_window_under_seq_is_refused_as_the_reference_does():
    with pytest.raises(ValueError) as want:
        jprobe.TransformerConfig(attn_parallel="seq", window=4)
    with pytest.raises(ValueError) as got:
        TransformerConfig(attn_parallel="seq", window=4)
    assert str(got.value) == str(want.value)


def _unsplittable_mesh():
    """A rank's Mesh of a 2 x 2 (data, seq) grid; the refusals raise before
    any collective, so no process group is needed."""
    return Mesh(("data", "seq"), (2, 2), 0, {}, torch.device("cpu"))


@pytest.mark.parametrize("batch", [(3, 8), (4, 7)])
def test_uneven_splits_are_refused_with_the_reference_message(batch):
    cfg = torch_mesh_ranks.config(GQA)
    jmesh = JaxMesh(np.array(jax.devices("cpu")[:4]).reshape(2, 2), ("data", "seq"))
    jparams = jprobe.init_params(_jax_cfg(cfg), jax.random.key(0))
    with pytest.raises(ValueError) as want:
        jprobe.forward(jparams, jnp.zeros(batch, jnp.int32), _jax_cfg(cfg), jmesh)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError) as got:
        loss_and_grads(params, torch.zeros(batch, dtype=torch.long), cfg,
                       mesh=_unsplittable_mesh())
    assert str(got.value) == str(want.value)


def test_the_seq_layout_takes_no_other_attention():
    cfg = torch_mesh_ranks.config(GQA)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="ring_attention"):
        loss_and_grads(params, torch.zeros((4, 8), dtype=torch.long), cfg,
                       attention=attention_plain, mesh=_unsplittable_mesh())


def test_seq_pipeline_check_runs_on_cpu():
    """The dryrun's dp x sp, ring and pipeline sections on 2 gloo ranks on
    the CPU (the dryrun's own shapes, d_head 4; no kernel runs here)."""
    results = seq_pipeline_check(1, 2, device="cpu", backend="gloo", timeout_s=SPAWN_TIMEOUT_S)
    no_launches = {"flash_fwd": 0, "dq": 0, "dkv": 0}
    for result in results:
        seq, pipe = result["seq"], result["pipeline"]
        assert seq["loss_err"] < SHARDED_LOSS_ATOL and pipe["loss_err"] < SHARDED_LOSS_ATOL
        assert seq["ring_err"] < 1e-5 and seq["ring_flash_err"] < 1e-5
        assert seq["launches"] == pipe["launches"] == no_launches
        assert pipe["gpipe_err"] <= 1e-6 and pipe["n_micro"] == 4
        assert pipe["bubble"]["interleaved"] < pipe["bubble"]["gpipe"]
