"""The port's training loss and steps against the JAX reference on the CPU.

JAX ``init_params`` weights go through numpy into the port
(``params_from_jax``); both sides run on the same numpy tokens. The
reference runs with ``attn_backend="xla"`` (its CPU path), and once with
``"pallas"``, where its backward kernels run in interpret mode. On the CPU
the port's attention backward is ``attention_bwd_plain`` behind the
autograd Function, the formula the card's kernels are held to.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from gpumounter_tpu.models import probe as jprobe
from gpumounter_tpu.parallel.train_step import sgd_update as jax_sgd_update
from gpumounter_tpu_torch.entry import TRAIN_GRAD_ATOL, train_check
from gpumounter_tpu_torch.models import probe as tprobe
from gpumounter_tpu_torch.parallel.train_step import (loss_and_grads,
                                                      make_train_step,
                                                      make_train_step_optim,
                                                      tree_leaves, tree_map)

from test_torch_probe import MOE_FLAGSHIP, SMALL, _both, _jax_cfg


@pytest.fixture(autouse=True)
def _cpu_default():
    with jax.default_device(jax.devices("cpu")[0]):
        yield


# The reference's dryrun flagship (__graft_entry__._flagship_cfg), d_head 4.
FLAGSHIP = dict(n_layers=2, d_model=64, n_heads=16, d_ff=128, max_len=32,
                n_kv_heads=8, window=8, rope=True)


def _tokens(cfg, shape=(2, 16), seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape)


_jax_loss_and_grads = jax.jit(jax.value_and_grad(jprobe.loss_fn),
                              static_argnums=(2,))


def _jax_value_and_grad(jparams, tokens, jcfg):
    loss, grads = _jax_loss_and_grads(jparams, jnp.asarray(tokens, jnp.int32),
                                      jcfg)
    return float(loss), jax.tree.map(lambda g: np.asarray(g, np.float32),
                                      grads)


def _assert_tree_close(got: dict, want: dict, atol: float, rtol: float = 0.0,
                       of_max: bool = False):
    """Each leaf of the port's tree against the reference's numpy tree; with
    of_max, atol is a share of each reference leaf's max |value|."""
    def check(g, w):
        w = np.asarray(w, np.float32)
        limit = atol * np.abs(w).max() if of_max else atol
        np.testing.assert_allclose(g.detach().float().numpy(), w,
                                   atol=limit, rtol=rtol)
    tree_map(check, got, want)


# (config, atol on the loss, atol on the grads, grads' atol relative to
# each leaf's max |grad|). f32: only the summation order differs. bf16: the
# two frameworks round activations and their grads at different places; 1
# bf16 ulp is 2^-8 of a value, and a grad leaf gathers a few such roundings
# through two layers (1.4% of its max |grad| seen), so 3% (about 8 ulps);
# the loss is the f32 mean of log-softmaxes of logits that differ by about
# an ulp (1.4e-6 seen).
LOSS_CASES = {
    "dense_mha_f32": (tprobe.TransformerConfig(dtype=torch.float32, **SMALL),
                      2e-6, 1e-6, False),
    "flagship_d_head4_f32": (tprobe.TransformerConfig(dtype=torch.float32,
                                                      **FLAGSHIP),
                             2e-6, 1e-6, False),
    "dense_mha_bf16": (tprobe.TransformerConfig(dtype=torch.bfloat16, **SMALL),
                       1e-4, 3e-2, True),
    "moe4_flagship_f32": (tprobe.TransformerConfig(dtype=torch.float32, **MOE_FLAGSHIP),
                          2e-6, 1e-6, False),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_loss_and_grads_match_reference(case):
    cfg, loss_atol, grad_atol, of_max = LOSS_CASES[case]
    jparams, params = _both(cfg)
    tokens = _tokens(cfg)
    want_loss, want_grads = _jax_value_and_grad(jparams, tokens, _jax_cfg(cfg))
    loss, grads = loss_and_grads(params, torch.from_numpy(tokens), cfg)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert loss.item() == pytest.approx(want_loss, abs=loss_atol)
    for leaf, param in zip(tree_leaves(grads), tree_leaves(params)):
        assert leaf.dtype == param.dtype and leaf.shape == param.shape
    _assert_tree_close(grads, want_grads, grad_atol, of_max=of_max)


def test_loss_and_grads_match_reference_pallas_backward():
    """The flagship against the reference with attn_backend="pallas": its
    flash_attention_with_lse forward and the two backward kernels run in
    interpret mode."""
    cfg = tprobe.TransformerConfig(dtype=torch.float32, **FLAGSHIP)
    jparams, params = _both(cfg, seed=1)
    tokens = _tokens(cfg, seed=1)
    jcfg = dataclasses.replace(_jax_cfg(cfg), attn_backend="pallas")
    want_loss, want_grads = _jax_value_and_grad(jparams, tokens, jcfg)
    loss, grads = loss_and_grads(params, torch.from_numpy(tokens), cfg)
    assert loss.item() == pytest.approx(want_loss, abs=2e-6)
    _assert_tree_close(grads, want_grads, 1e-6)


def test_moe_aux_weight_enters_the_loss():
    """loss_fn = the nll of forward + moe_aux_weight x the mean aux, on both
    sides; the Switch aux is ~1 at init, so weight 0.5 against 0 moves the
    loss by about 0.5."""
    cfg = tprobe.TransformerConfig(dtype=torch.float32, **MOE_FLAGSHIP)
    jparams, params = _both(cfg, seed=6)
    tokens = _tokens(cfg, seed=6)
    losses = {}
    for weight in (0.0, 0.01, 0.5):
        c = dataclasses.replace(cfg, moe_aux_weight=weight)
        want = float(jprobe.loss_fn(jparams, jnp.asarray(tokens, jnp.int32), _jax_cfg(c)))
        losses[weight] = tprobe.loss_fn(params, torch.from_numpy(tokens), c).item()
        assert losses[weight] == pytest.approx(want, abs=2e-6), weight
    nll = tprobe.next_token_nll(tprobe.forward(params, torch.from_numpy(tokens), cfg),
                                torch.from_numpy(tokens)).item()
    assert losses[0.0] == pytest.approx(nll, abs=1e-6)
    aux = (losses[0.5] - losses[0.0]) / 0.5
    assert 0.9 < aux < 1.5
    assert losses[0.01] - losses[0.0] == pytest.approx(0.01 * aux, abs=1e-5)


def test_moe_tree_leaves_order_matches_jax():
    """An MoE block's leaves in jax.tree.leaves's order (ln1, ln2, router,
    w1, w2, wo, wqkv), so grads and optimizer state line up leaf by leaf."""
    cfg = tprobe.TransformerConfig(dtype=torch.float32, **MOE_FLAGSHIP)
    jparams, params = _both(cfg)
    want = jax.tree.leaves(jparams["blocks"])
    got = tree_leaves(params)[1:]  # after embed (rope: no pos table)
    assert len(got) == len(want) == 7 * cfg.n_layers
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_loss_fn_is_the_nll_of_forward():
    cfg = tprobe.TransformerConfig(dtype=torch.float32, **SMALL)
    _, params = _both(cfg)
    tokens = torch.from_numpy(_tokens(cfg))
    want = tprobe.next_token_nll(tprobe.forward(params, tokens, cfg), tokens)
    torch.testing.assert_close(tprobe.loss_fn(params, tokens, cfg), want)


def test_loss_and_grads_leave_params_alone():
    cfg = tprobe.TransformerConfig(dtype=torch.float32, **SMALL)
    _, params = _both(cfg)
    before = [t.clone() for t in tree_leaves(params)]
    loss_and_grads(params, torch.from_numpy(_tokens(cfg)), cfg)
    for t, b in zip(tree_leaves(params), before):
        assert not t.requires_grad and torch.equal(t, b)


def test_three_sgd_steps_match_reference():
    cfg = tprobe.TransformerConfig(dtype=torch.float32, n_kv_heads=2,
                                   window=5, rope=True, **SMALL)
    jparams, params = _both(cfg, seed=2)
    jcfg, lr = _jax_cfg(cfg), 0.1
    step = make_train_step(cfg, lr=lr)
    for i in range(3):
        tokens = _tokens(cfg, seed=10 + i)
        want_loss, grads = _jax_value_and_grad(jparams, tokens, jcfg)
        jparams = jax_sgd_update(jparams, grads, lr)
        params, loss = step(params, torch.from_numpy(tokens))
        assert loss.item() == pytest.approx(want_loss, abs=2e-6), i
    _assert_tree_close(params, jax.tree.map(np.asarray, jparams), 1e-6)


def test_three_sgd_steps_match_reference_moe():
    """The MoE flagship: 3 SGD steps, the router kept float32 by the f32
    update of a bf16 model."""
    cfg = tprobe.TransformerConfig(dtype=torch.float32, **MOE_FLAGSHIP)
    jparams, params = _both(cfg, seed=7)
    jcfg, lr = _jax_cfg(cfg), 0.1
    step = make_train_step(cfg, lr=lr)
    for i in range(3):
        tokens = _tokens(cfg, seed=30 + i)
        want_loss, grads = _jax_value_and_grad(jparams, tokens, jcfg)
        jparams = jax_sgd_update(jparams, grads, lr)
        params, loss = step(params, torch.from_numpy(tokens))
        assert loss.item() == pytest.approx(want_loss, abs=2e-6), i
    _assert_tree_close(params, jax.tree.map(np.asarray, jparams), 1e-6)
    bf16 = tprobe.TransformerConfig(dtype=torch.bfloat16, **MOE_FLAGSHIP)
    _, p16 = _both(bf16)
    new, _ = make_train_step(bf16, lr=lr)(p16, torch.from_numpy(_tokens(bf16)))
    for blk in new["blocks"]:
        assert blk["router"].dtype == torch.float32 and blk["w1"].dtype == torch.bfloat16


def test_three_adamw_steps_match_optax():
    cfg = tprobe.TransformerConfig(dtype=torch.float32, **SMALL)
    params, jparams, _ = _adamw_steps(cfg)
    # Adam divides each grad by sqrt(v), so where a grad is near 0 its f32
    # rounding differences reach the update whole: allow 1% of one step's
    # lr (2.1e-5 seen on one weight of 2048).
    _assert_tree_close(params, jax.tree.map(np.asarray, jparams), 1e-4)


def test_three_adamw_steps_match_optax_moe():
    """The MoE flagship under AdamW; the router stays float32. This
    config's grads are small (sqrt of Adam's second moment below 1e-6 on
    half of one layer's wqkv), and Adam divides each grad by that RMS, so
    a grad error Δg moves a step's update by up to lr·Δg/(sqrt(v) + eps).
    With Δg at the 1e-6 the loss-and-grads case holds the grads to, each
    weight is held within 1e-4 + 3 steps of lr·min(1, 1e-6/(sqrt(v) +
    eps)), v optax's second moment after the steps (3.4e-4 seen on one
    expert weight whose grads' RMS is 3.7e-8)."""
    cfg = tprobe.TransformerConfig(dtype=torch.float32, **MOE_FLAGSHIP)
    params, jparams, jstate = _adamw_steps(cfg)

    def check(got, want, v):
        diff = np.abs(got.detach().numpy() - np.asarray(want))
        limit = 1e-4 + 3 * 1e-2 * np.minimum(1.0, 1e-6 / (np.sqrt(np.asarray(v)) + 1e-8))
        assert got.dtype == torch.float32 and (diff <= limit).all(), diff.max()

    tree_map(check, params, *(jax.tree.map(np.asarray, t) for t in (jparams, jstate[0].nu)))


def _adamw_steps(cfg):
    """3 AdamW steps (lr 1e-2, weight decay 1e-4) of the port and of optax
    from the same weights, the losses held within 2e-6; returns (port
    params, reference params, optax state)."""
    jparams, params = _both(cfg, seed=3)
    jcfg, lr, wd = _jax_cfg(cfg), 1e-2, 1e-4
    tx = optax.adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=wd)
    jstate = tx.init(jparams)
    init_fn, step_fn = make_train_step_optim(
        cfg, lambda ps: torch.optim.AdamW(ps, lr=lr, betas=(0.9, 0.999),
                                          eps=1e-8, weight_decay=wd))
    opt_state = init_fn(params)
    for i in range(3):
        tokens = _tokens(cfg, seed=20 + i)
        want_loss, grads = _jax_value_and_grad(jparams, tokens, jcfg)
        updates, jstate = tx.update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        params, opt_state, loss = step_fn(params, opt_state,
                                          torch.from_numpy(tokens))
        assert loss.item() == pytest.approx(want_loss, abs=2e-6), i
    return params, jparams, jstate


def test_train_check_runs_on_cpu():
    result = train_check(device="cpu")
    assert np.isfinite(result["loss"])
    assert 0 <= result["max_grad_err"] < TRAIN_GRAD_ATOL


def test_train_check_without_device_raises_on_a_host_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_check()
