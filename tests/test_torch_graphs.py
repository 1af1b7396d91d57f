"""The port's cached programs (``ops.graphs``) on the CPU.

On the card ``forward``, ``make_train_step``'s step and ``generate`` run as
CUDA graphs cached per key, the counterpart of the reference's jitted
programs; a CPU tensor runs the eager bodies. Here: the keys (what jit keys
on, plus the storage of what a graph reads in place), the refusals of
capture=True on CPU tensors, the CPU train step against the reference's
jitted ``make_train_step`` on a one-device mesh (XLA attention), the
caller's params left alone, the bodies free of host reads (a CUDA graph
could not capture one), and the cache's plumbing driven through a stand-in
capture that runs its bodies eagerly: what a miss and a hit return, what
they copy, what they capture, and the generator state a sampled decoder
carries in and out. The graphs themselves run on the card
(``test_torch_graphs_gpu.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh

from gpumounter_tpu.parallel import train_step as jts
from gpumounter_tpu_torch.models import probe as tprobe
from gpumounter_tpu_torch.ops import graphs
from gpumounter_tpu_torch.ops.flash_attention import attention_plain
from gpumounter_tpu_torch.parallel.train_step import (make_train_step, train_step_key,
                                                      tree_leaves, tree_map)

from test_torch_moe import NoHostReads
from test_torch_probe import MOE_FLAGSHIP, SMALL, _both, _jax_cfg


@pytest.fixture(autouse=True)
def _cpu_default():
    with jax.default_device(jax.devices("cpu")[0]):
        yield


@pytest.fixture(autouse=True)
def _empty_cache():
    graphs.clear_graphs()
    yield
    graphs.clear_graphs()


# The card tests' configs at f32 on the CPU: dense with GQA and a window,
# and the reference's MoE flagship dialect.
CONFIGS = {
    "dense": tprobe.TransformerConfig(dtype=torch.float32, n_kv_heads=2, window=5, rope=True,
                                      **SMALL),
    "moe": tprobe.TransformerConfig(dtype=torch.float32, **MOE_FLAGSHIP),
}


def _tokens(cfg, shape=(2, 12), seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab, shape))


def _params(cfg, seed=0):
    return tprobe.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")


# --- the keys ---


def test_forward_key_is_the_config_the_tokens_layout_and_the_params_storage():
    cfg = CONFIGS["dense"]
    params, tokens = _params(cfg), _tokens(cfg)
    key = tprobe.forward_key(params, tokens, cfg)
    assert tprobe.forward_key(params, tokens.clone(), cfg) == key  # tokens are copied in
    assert tprobe.forward_key(params, _tokens(cfg, seed=1), cfg) == key
    assert tprobe.forward_key(params, _tokens(cfg, (3, 12)), cfg) != key
    assert tprobe.forward_key(params, tokens.int(), cfg) != key
    assert tprobe.forward_key(tree_map(torch.clone, params), tokens, cfg) != key
    assert tprobe.forward_key(params, tokens, dataclasses.replace(cfg, window=4)) != key


@pytest.mark.parametrize("name", list(CONFIGS))
def test_generate_key_is_the_static_arguments_the_prompt_layout_and_the_params_storage(name):
    cfg = CONFIGS[name]
    params, prompt = _params(cfg), _tokens(cfg, (2, 5))
    key = tprobe.generate_key(params, prompt, cfg, 6, False)
    assert tprobe.generate_key(params, _tokens(cfg, (2, 5), seed=3), cfg, 6, False) == key
    changed = [tprobe.generate_key(params, _tokens(cfg, (2, 6)), cfg, 6, False),
               tprobe.generate_key(params, _tokens(cfg, (3, 5)), cfg, 6, False),
               tprobe.generate_key(params, prompt, cfg, 7, False),
               tprobe.generate_key(params, prompt, cfg, 6, True),
               tprobe.generate_key(tree_map(torch.clone, params), prompt, cfg, 6, False)]
    assert all(other != key for other in changed)
    assert len(set(changed)) == len(changed)


def test_train_step_key_holds_layouts_not_storage():
    """The step copies the params in, so fresh params of the same layout
    (the last step's output) replay the same graph."""
    cfg = CONFIGS["dense"]
    params, tokens = _params(cfg), _tokens(cfg)
    key = train_step_key(params, tokens, cfg, 0.1)
    assert train_step_key(tree_map(torch.clone, params), tokens.clone(), cfg, 0.1) == key
    assert train_step_key(params, tokens, cfg, 0.2) != key
    assert train_step_key(params, _tokens(cfg, (2, 13)), cfg, 0.1) != key
    assert train_step_key(tree_map(lambda p: p.bfloat16(), params), tokens, cfg, 0.1) != key
    assert train_step_key(params, tokens, CONFIGS["moe"], 0.1) != key


def test_graph_key_separates_what_is_copied_from_what_is_read():
    a = torch.zeros(4, 3)
    b = a.clone()
    assert graphs.graph_key(("x",), copied=(a,)) == graphs.graph_key(("x",), copied=(b,))
    assert graphs.graph_key(("x",), read=(a,)) != graphs.graph_key(("x",), read=(b,))
    assert graphs.graph_key(("x",), copied=(a,)) != graphs.graph_key(("x",), copied=(a.t(),))
    assert graphs.graph_key(("x",), read=[a]) != graphs.graph_key(("y",), read=[a])


# --- refusals ---


def test_capture_on_cpu_tensors_raises():
    cfg = CONFIGS["dense"]
    params, tokens = _params(cfg), _tokens(cfg)
    with pytest.raises(ValueError, match="capture needs a CUDA batch"):
        make_train_step(cfg, 0.1, capture=True)(params, tokens)
    with pytest.raises(ValueError, match="capture needs a CUDA batch"):
        tprobe.forward(params, tokens, cfg, capture=True)
    with pytest.raises(ValueError, match="capture needs a CUDA prompt"):
        tprobe.generate_loop(params, tokens[:, :4], cfg, 3, capture=True)
    assert graphs.capture.captures == 0


def test_a_captured_step_takes_no_mesh():
    with pytest.raises(ValueError, match="no mesh"):
        make_train_step(CONFIGS["dense"], 0.1, mesh=object(), capture=True)


def test_cpu_tensors_run_the_eager_bodies(monkeypatch):
    """capture=None on CPU tensors: no capture, no cache entry."""
    monkeypatch.setattr(graphs, "capture", _no_capture)
    cfg = CONFIGS["moe"]
    params, tokens = _params(cfg), _tokens(cfg)
    make_train_step(cfg, 0.1)(params, tokens)
    tprobe.forward(params, tokens, cfg)
    tprobe.generate(params, tokens[:, :4], cfg, 3)
    assert [graphs.cached(p) for p in ("train_step", "forward", "generate")] == [None] * 3


def _no_capture(*args, **kwargs):
    raise AssertionError("a CPU tensor reached a capture")


# --- the CPU step against the reference's jitted step ---


@pytest.mark.parametrize("name", list(CONFIGS))
def test_two_sgd_steps_match_the_reference_jitted_step(name):
    """make_train_step on the CPU (the eager body, the plain attention)
    against the reference's jax.jit step over a one-device ("data",
    "model") mesh with XLA attention: f32, so only the summation order
    differs; the losses within 2e-6 and every param within 1e-6, as
    test_torch_train_step.py holds the unjitted reference."""
    cfg = CONFIGS[name]
    jparams, params = _both(cfg, seed=4)
    jcfg, lr = _jax_cfg(cfg), 0.1
    mesh = Mesh(np.array(jax.devices("cpu")[:1]).reshape(1, 1), ("data", "model"))
    jstep = jts.make_train_step(mesh, jcfg, lr)
    jparams = jts.shard_params(jparams, mesh, jcfg)
    step = make_train_step(cfg, lr=lr)
    for i in range(2):
        tokens = np.random.default_rng(40 + i).integers(0, cfg.vocab, (2, 16))
        jparams, want = jstep(jparams, jnp.asarray(tokens, jnp.int32))
        params, loss = step(params, torch.from_numpy(tokens))
        assert loss.item() == pytest.approx(float(want), abs=2e-6), i
    tree_map(lambda got, want: np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0),
             params, jax.tree.map(np.asarray, jparams))


@pytest.mark.parametrize("capture", [None, False])
def test_a_step_leaves_the_callers_params_alone(capture):
    cfg = CONFIGS["moe"]
    params = _params(cfg)
    before = [t.clone() for t in tree_leaves(params)]
    new, _ = make_train_step(cfg, 0.1, capture=capture)(params, _tokens(cfg))
    for t, b, n in zip(tree_leaves(params), before, tree_leaves(new), strict=True):
        assert torch.equal(t, b) and not t.requires_grad
        assert n.data_ptr() != t.data_ptr() and not torch.equal(n, t)


# --- the bodies a graph captures read no device value on the host ---


@pytest.mark.parametrize("name", list(CONFIGS))
def test_the_captured_bodies_read_no_device_value_on_the_host(name):
    """The train step (the loss, autograd, the update) and the forward, as
    the graphs run them, under ``NoHostReads``."""
    cfg = dataclasses.replace(CONFIGS[name], dtype=torch.bfloat16)
    params, tokens = _params(cfg), _tokens(cfg)
    step = make_train_step(cfg, 0.1, capture=False)
    with NoHostReads():
        new, loss = step(params, tokens)
        with torch.no_grad():
            logits = tprobe.forward(params, tokens, cfg, capture=False)
    assert torch.isfinite(loss) and torch.isfinite(logits).all()
    assert all(torch.isfinite(t).all() for t in tree_leaves(new))


# --- the cache's plumbing, through a stand-in capture ---


class _StandIn:
    """``graphs.capture`` without CUDA: the warm-up is a real call, as on
    the card; the "graph" is the body itself, which replay() runs eagerly,
    copying a pure body's output into the buffers the capture handed out
    (its "graph memory"). Counts captures and replays."""

    def __init__(self):
        self.captures = self.replays = 0

    def __call__(self, fn, generators=()):
        self.captures += 1
        first = fn()
        out = graphs._tree_map(torch.clone, first)

        def replay():
            self.replays += 1
            for buffer, value in zip(graphs.leaves(out), graphs.leaves(fn())):
                if buffer is not None:
                    buffer.copy_(value)

        return None, replay, out, first


@pytest.fixture
def stand_in(monkeypatch):
    fake = _StandIn()
    monkeypatch.setattr(graphs, "capture", fake)
    return fake


@pytest.mark.parametrize("name", list(CONFIGS))
def test_replayed_steps_equal_eager_steps_and_keep_what_they_returned(stand_in, name):
    """Three steps through ``graphs.replayed`` as ``make_train_step`` runs
    them on the card: one capture, two replays, each step's loss and params
    equal the eager step's, and what an earlier call returned is not
    rewritten by a later one."""
    cfg = CONFIGS[name]
    eager = make_train_step(cfg, 0.1, capture=False)

    def body(params, tokens):
        return eager(params, tokens)

    p_graph = p_eager = _params(cfg)
    kept = []
    for i in range(3):
        tokens = _tokens(cfg, seed=20 + i)
        key = train_step_key(p_graph, tokens, cfg, 0.1)
        p_graph, loss = graphs.replayed("train_step", key, body, (p_graph, tokens))
        p_eager, want = eager(p_eager, tokens)
        assert torch.equal(loss, want)
        for got, exp in zip(tree_leaves(p_graph), tree_leaves(p_eager), strict=True):
            assert torch.equal(got, exp)
        kept.append((loss, [t.clone() for t in tree_leaves(p_graph)], p_graph))
    assert (stand_in.captures, stand_in.replays) == (1, 2)
    for loss, copies, returned in kept:
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(returned), copies))
    entry = graphs.cached("train_step")
    assert all(not any(o.data_ptr() == t.data_ptr() for o in graphs.leaves(entry.out))
               for t in tree_leaves(kept[-1][2]))


def test_a_new_key_evicts_the_old_entry(stand_in):
    cfg = CONFIGS["dense"]
    params = _params(cfg)

    def body(tokens):
        return tprobe.forward(params, tokens, cfg, capture=False)

    for shape in ((2, 12), (2, 12), (3, 12), (3, 12), (2, 12)):
        tokens = _tokens(cfg, shape)
        got = graphs.replayed("forward", tprobe.forward_key(params, tokens, cfg), body,
                              (tokens,))
        assert torch.equal(got, body(tokens))
    assert (stand_in.captures, stand_in.replays) == (3, 2)
    assert graphs.cached("forward").inputs[0].shape == (2, 12)
    graphs.clear_graphs()
    assert graphs.cached("forward") is None


def test_lookup_store_and_clear():
    assert graphs.lookup("p", (1,)) is None
    graphs.store("p", (1,), "a")
    graphs.store("q", (1,), "b")
    assert graphs.lookup("p", (1,)) == "a" and graphs.cached("p") == "a"
    assert graphs.lookup("p", (2,)) is None and graphs.cached("p") is None
    assert graphs.cached("q") == "b"
    graphs.clear_graphs()
    assert graphs.cached("q") is None


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("seed", [None, 7])
def test_a_cached_decoder_generates_the_eager_tokens(stand_in, name, seed):
    """``generate``'s cached decoder on the CPU, through the stand-in: the
    first call runs the prefill and the first step as the warm-ups of two
    captures, later calls replay the prefill and n_new − 1 steps; the
    tokens and the caller's generator after each call are the eager loop's
    (the state copied into the decoder's own generator and back out), and
    a temperature sweep reuses the graphs."""
    cfg, n_new = CONFIGS[name], 6
    params = _params(cfg)
    decoder = tprobe._CapturedDecoder(params, _tokens(cfg, (2, 5)), cfg, n_new,
                                      sampled=seed is not None)

    def gen():
        return None if seed is None else torch.Generator().manual_seed(seed)

    mine, theirs = gen(), gen()
    for i, temperature in enumerate((1.0, 0.7, 1.3)):
        prompt = _tokens(cfg, (2, 5), seed=60 + i)
        t = torch.tensor(temperature)
        got = decoder(prompt, t, mine, n_new)
        want = tprobe.generate_loop(params, prompt, cfg, n_new, theirs,
                                    None if seed is None else t, capture=False)
        assert torch.equal(got, want), i
        if seed is not None:
            assert torch.equal(mine.get_state(), theirs.get_state())
    assert stand_in.captures == 2
    # the first call's n_new - 2 further steps, then two calls of the
    # prefill and n_new - 1 steps each
    assert stand_in.replays == n_new - 2 + 2 * n_new


def test_one_new_token_captures_the_prefill_alone(stand_in):
    cfg = CONFIGS["dense"]
    params, prompt = _params(cfg), _tokens(cfg, (2, 5))
    decoder = tprobe._CapturedDecoder(params, prompt, cfg, 1, sampled=False)
    for _ in range(2):
        assert torch.equal(decoder(prompt, torch.tensor(1.0), None, 1),
                           tprobe.generate_loop(params, prompt, cfg, 1, capture=False))
    assert (stand_in.captures, stand_in.replays) == (1, 1)


def test_the_plain_attention_forward_stays_eager():
    """The checks' forward (attention_plain) is never a cached graph, and
    capture=True refuses it."""
    cfg = CONFIGS["dense"]
    params, tokens = _params(cfg), _tokens(cfg)
    with pytest.raises(ValueError, match="capture"):
        tprobe.forward(params, tokens, cfg, attention=attention_plain, capture=True)
    with pytest.raises(ValueError, match="default attention"):
        tprobe.forward(params, tokens.to("meta"), cfg, attention=attention_plain, capture=True)
