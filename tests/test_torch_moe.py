"""The port's MoE FFN (``parallel/moe.py``) against the JAX reference on the
CPU.

The reference's ``init_moe_params`` weights go through numpy into torch;
both sides run on the same numpy tokens. Routing must be identical: the
router logits are float32 products of identical inputs on both sides.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from torch.utils._python_dispatch import TorchDispatchMode

from gpumounter_tpu.parallel import moe as jmoe
from gpumounter_tpu_torch.entry import TRAIN_GRAD_ATOL, moe_check
from gpumounter_tpu_torch.parallel import moe as tmoe

_DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
T, D_MODEL, D_FF = 64, 32, 64
# Output: f32 differs by the order of summation only (1e-7 of max seen);
# bf16 by where the two frameworks round the expert products and GELU
# (1.4 bf16 ulps of the output's max |value| seen), held to 4 ulps (2^-8
# each) of the max. aux is a float32 mean of identical probabilities.
OUT_OF_MAX = {"f32": 1e-6, "bf16": 4 * 2**-8}
AUX_ATOL = 1e-6
# Grads as a share of each reference leaf's max |grad|: f32 summation order
# (3e-7 seen); bf16 roundings of activations and of the grads themselves
# (0.9% seen), held to 3% (about 8 ulps), as the probe's bf16 loss case.
GRAD_OF_MAX = {"f32": 1e-6, "bf16": 3e-2}


@pytest.fixture(autouse=True)
def _cpu_default():
    with jax.default_device(jax.devices("cpu")[0]):
        yield


def _torch(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _f32(arr) -> np.ndarray:
    return np.asarray(jnp.asarray(arr).astype(jnp.float32))


def _setup(n_experts, dtype, seed=0):
    """(jax params, port params, jax x, port x): the same values."""
    jdt, _ = _DTYPES[dtype]
    jparams = jmoe.init_moe_params(jax.random.key(seed), n_experts, D_MODEL, D_FF, jdt)
    x = jnp.asarray(np.random.default_rng(seed).normal(size=(T, D_MODEL)), jdt)
    return jparams, {k: _torch(v) for k, v in jparams.items()}, x, _torch(x)


@jax.jit
def _jax_route(jparams, x):
    return jnp.argmax(jax.nn.softmax(x.astype(jnp.float32) @ jparams["router"], -1), -1)


CASES = [(e, dt) for dt in ("f32", "bf16") for e in (2, 4, 8)]
IDS = [f"E{e}_{dt}" for e, dt in CASES]


@pytest.mark.parametrize("n_experts,dtype", CASES, ids=IDS)
def test_moe_ffn_matches_reference(n_experts, dtype):
    jparams, params, jx, x = _setup(n_experts, dtype, seed=n_experts)
    want, want_aux = jax.jit(jmoe.moe_ffn)(jparams, jx)
    got, aux = tmoe.moe_ffn(params, x)
    assert got.dtype == x.dtype and got.shape == x.shape
    assert params["router"].dtype == torch.float32 and aux.dtype == torch.float32
    idx, probs = tmoe._route(params, x)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(_jax_route(jparams, jx)))
    assert len(set(idx.tolist())) > 1  # more than one expert is exercised
    want = _f32(want)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=OUT_OF_MAX[dtype] * np.abs(want).max())
    assert aux.item() == pytest.approx(float(want_aux), abs=AUX_ATOL)


@pytest.mark.parametrize("n_experts,dtype", CASES, ids=IDS)
def test_moe_ffn_grads_match_reference(n_experts, dtype):
    """Grads of sum(out · g) + aux for x, router, w1 and w2 against
    jax.grad, g a fixed random cotangent."""
    jparams, params, jx, x = _setup(n_experts, dtype, seed=10 + n_experts)
    g = np.random.default_rng(n_experts).normal(size=(T, D_MODEL)).astype(np.float32)

    def jax_loss(p, xx):
        out, aux = jmoe.moe_ffn(p, xx)
        return jnp.sum(out.astype(jnp.float32) * g) + aux

    want_p, want_x = jax.jit(jax.grad(jax_loss, argnums=(0, 1)))(jparams, jx)
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    xx = x.detach().requires_grad_()
    out, aux = tmoe.moe_ffn(leaves, xx)
    loss = (out.float() * torch.from_numpy(g)).sum() + aux
    names = ("router", "w1", "w2")
    got = torch.autograd.grad(loss, [leaves[k] for k in names] + [xx])
    for name, gt, w in zip(names + ("x",), got, [want_p[k] for k in names] + [want_x]):
        w = _f32(w)
        assert gt.dtype == (torch.float32 if name == "router" else x.dtype), name
        np.testing.assert_allclose(gt.float().numpy(), w, rtol=0,
                                   atol=GRAD_OF_MAX[dtype] * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("n_experts,dtype", CASES, ids=IDS)
def test_moe_ffn_plain_matches_moe_ffn(n_experts, dtype):
    """The loop over experts gathers each expert's tokens by index; on the
    CPU the same rows go through the same products, so it agrees to the
    f32 order of summation of the aux means (1e-6)."""
    _, params, _, x = _setup(n_experts, dtype, seed=20 + n_experts)
    want, want_aux = tmoe.moe_ffn(params, x)
    got, aux, idx = tmoe.moe_ffn_plain(params, x)
    torch.testing.assert_close(idx, tmoe._route(params, x)[0], rtol=0, atol=0)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=OUT_OF_MAX[dtype] * want.float().abs().max().item())
    assert aux.item() == pytest.approx(want_aux.item(), abs=AUX_ATOL)


def test_moe_ffn_plain_catches_a_wrong_dispatch():
    """Tokens sent to the wrong expert show: route every token one expert
    over and the two formulations disagree."""
    _, params, _, x = _setup(4, "f32")
    shifted = dict(params, w1=params["w1"].roll(1, dims=0), w2=params["w2"].roll(1, dims=0))
    want, _ = tmoe.moe_ffn(params, x)
    got, _, _ = tmoe.moe_ffn_plain(shifted, x)
    assert (got - want).abs().max() > 100 * OUT_OF_MAX["f32"] * want.abs().max()


def test_init_moe_params_layout():
    params = tmoe.init_moe_params(torch.Generator().manual_seed(0), 8, 64, 128,
                                  torch.bfloat16, "cpu")
    want = jmoe.init_moe_params(jax.random.key(0), 8, 64, 128)
    for key in ("router", "w1", "w2"):
        assert tuple(params[key].shape) == want[key].shape, key
        assert 0.015 < params[key].float().std().item() < 0.025, key
    assert params["router"].dtype == torch.float32
    assert params["w1"].dtype == params["w2"].dtype == torch.bfloat16


class NoHostReads(TorchDispatchMode):
    """Raises on every op whose result needs a device value on the host:
    .item() (``_local_scalar_dense``), ``nonzero``, ``masked_select`` and
    indexing by a boolean mask (its output's shape depends on the data).
    Under it, code that a CUDA graph could not capture fails on the CPU."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        bool_index = name.startswith("index") and any(
            isinstance(i, torch.Tensor) and i.dtype == torch.bool
            for a in args if isinstance(a, (list, tuple)) for i in a)
        if name in ("_local_scalar_dense", "nonzero", "masked_select") or bool_index:
            raise AssertionError(f"{func} reads a device value on the host")
        return func(*args, **(kwargs or {}))


def test_no_host_reads_catches_them():
    x = torch.arange(4.0)
    for read in (lambda: x.sum().item(), lambda: x[x > 1], lambda: x.nonzero()):
        with pytest.raises(AssertionError, match="host"), NoHostReads():
            read()


def test_moe_ffn_reads_no_device_value_on_the_host():
    """The decode step runs moe_ffn and must stay capturable; the loop
    over experts, by contrast, gathers by index and is caught."""
    _, params, _, x = _setup(4, "bf16")
    with NoHostReads():
        out, aux = tmoe.moe_ffn(params, x)
    assert torch.isfinite(out).all() and torch.isfinite(aux)
    with pytest.raises(AssertionError, match="host"), NoHostReads():
        tmoe.moe_ffn_plain(params, x)


# make_moe_step against the reference's on a 1 x 1 ("data", "expert") CPU
# mesh, 3 steps at lr 0.1. f32: summation order (loss within 1e-6, params
# within 1e-6 of each leaf's max). bf16: each step's grads differ by the
# bf16 roundings above, and the update rounds each weight to bf16, so a
# weight can land one ulp apart (2^-8 of itself; the weights are ~0.02 to
# 0.08): params within 2 ulps of each leaf's max, the loss within 1e-4.
STEP_TOL = {"f32": (1e-6, 1e-6), "bf16": (1e-4, 2 * 2**-8)}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_make_moe_step_matches_reference(dtype):
    jdt, tdt = _DTYPES[dtype]
    n_experts, lr = 4, 0.1
    mesh = Mesh(np.array(jax.devices("cpu")[:1]).reshape(1, 1), ("data", "expert"))
    jparams = jmoe.shard_moe_params(
        jmoe.init_moe_params(jax.random.key(1), n_experts, D_MODEL, D_FF, jdt), mesh)
    params = {k: _torch(v) for k, v in jparams.items()}
    jstep = jmoe.make_moe_step(mesh, n_experts, D_MODEL, D_FF, lr=lr)
    step = tmoe.make_moe_step(n_experts, D_MODEL, D_FF, lr=lr)
    loss_atol, param_of_max = STEP_TOL[dtype]
    rng = np.random.default_rng(2)
    for i in range(3):
        x, target = (jnp.asarray(rng.normal(size=(8, D_MODEL)), jdt) for _ in range(2))
        sharded = [jax.device_put(a, NamedSharding(mesh, P("data", None))) for a in (x, target)]
        jparams, want_loss = jstep(jparams, *sharded)
        params, loss = step(params, _torch(x), _torch(target))
        assert loss.dtype == torch.float32
        assert loss.item() == pytest.approx(float(want_loss), abs=loss_atol), i
    for key, value in params.items():
        want = _f32(jparams[key])
        assert value.dtype == (torch.float32 if key == "router" else tdt), key
        np.testing.assert_allclose(value.float().numpy(), want, rtol=0,
                                   atol=param_of_max * np.abs(want).max(), err_msg=key)


def test_make_moe_step_refuses_params_of_other_sizes():
    params = tmoe.init_moe_params(torch.Generator().manual_seed(0), 4, D_MODEL, D_FF,
                                  torch.float32, "cpu")
    step = tmoe.make_moe_step(2, D_MODEL, D_FF)
    x = torch.ones((8, D_MODEL))
    with pytest.raises(ValueError, match="the step was made for"):
        step(params, x, x)


def test_moe_check_runs_on_cpu():
    result = moe_check(device="cpu")
    assert np.isfinite(result["loss"]) and len(result["moe_step_losses"]) == 3
    assert all(np.isfinite(result["moe_step_losses"]))
    assert 0 <= result["max_grad_err"] < TRAIN_GRAD_ATOL
    assert result["flipped"] == [0, 0]  # the plain version on both sides


def test_moe_check_without_device_raises_on_a_host_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        moe_check()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmoe.init_moe_params(torch.Generator().manual_seed(0), 2, 8, 8)
