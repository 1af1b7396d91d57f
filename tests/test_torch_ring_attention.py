"""The port's ring attention and ring shift against the reference on the CPU.

The reference runs ``ring_attention`` under ``shard_map`` on the virtual CPU
devices of ``tests/conftest.py``, on a ("seq",) mesh of 2 and of 4 devices
(its einsum body, and the interpret-mode flash body for the softcap case,
which forces it). The port runs the same numpy q, k, v on 2 and 4 gloo
ranks (``parallel.launch.run_ranks``), one spawn per world size with every
case inside it (``torch_mesh_ranks.ring_cases``); each rank returns its
output chunk and the gradients in its chunks of q, k and v of
sum(out · do), which the tests join along the sequence. f32 throughout:
the two differ in the order of the sums only.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh

from gpumounter_tpu.parallel.ring_attention import _combine_chunks as jax_combine_chunks
from gpumounter_tpu.parallel.ring_attention import reference_attention as jax_reference_attention
from gpumounter_tpu.parallel.ring_attention import ring_attention as jax_ring_attention
from gpumounter_tpu.parallel.ring_attention import shard_qkv as jax_shard_qkv
from gpumounter_tpu_torch.ops.flash_attention import NEG_INF
from gpumounter_tpu_torch.parallel import ring_attention as tring
from gpumounter_tpu_torch.parallel.launch import run_ranks

import torch_mesh_ranks

SPAWN_TIMEOUT_S = 120.0  # its own limit: a hung rank fails this module only
WORLDS = (2, 4)
ATOL = 1e-5
# name: (B, H, H_kv, chunk, D, causal, softcap, worlds). The chunk is a
# rank's share of the sequence, so L = chunk · n.
CASES = {
    "causal": ((2, 4, 4, 4, 8), True, None, WORLDS),
    "non_causal": ((2, 4, 4, 4, 8), False, None, WORLDS),
    "gqa_causal": ((1, 4, 2, 3, 8), True, None, WORLDS),
    "gqa_non_causal": ((1, 4, 1, 3, 8), False, None, (4,)),
    # The reference caps only in its interpret-mode flash body (~1 s a call
    # here), so one tiny case.
    "softcap_causal": ((1, 2, 2, 4, 8), True, 5.0, (2,)),
}


def _inputs(name, n):
    (b, h, h_kv, chunk, d), *_ = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)) + n)
    shapes = [(b, h, chunk * n, d)] + [(b, h_kv, chunk * n, d)] * 2 + [(b, h, chunk * n, d)]
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


@pytest.fixture(scope="module")
def runs():
    out = {}
    for n in WORLDS:
        cases = {name: {"qkv_do": _inputs(name, n), "causal": causal, "softcap": softcap}
                 for name, (_, causal, softcap, worlds) in CASES.items() if n in worlds}
        out[n] = run_ranks(torch_mesh_ranks.ring_cases, n, backend="gloo", args=(n, cases),
                           timeout_s=SPAWN_TIMEOUT_S)
    return out


def _reference(name, n):
    """(out, (dq, dk, dv)) of the reference's ring_attention on n devices."""
    _, causal, softcap, _ = CASES[name]
    q, k, v, do = (jnp.asarray(a) for a in _inputs(name, n))
    mesh = Mesh(np.array(jax.devices("cpu")[:n]), ("seq",))
    fn = jax.jit(lambda a, b, c: jax_ring_attention(a, b, c, mesh, causal=causal,
                                                    softcap=softcap))
    out, vjp = jax.vjp(fn, *(jax_shard_qkv(x, mesh) for x in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in vjp(do)]


def _joined(results, name, key):
    if key == "out":
        return np.concatenate([r[name]["out"] for r in results], axis=2)
    return [np.concatenate([r[name]["grads"][i] for r in results], axis=2) for i in range(3)]


@pytest.mark.parametrize("n,name", [(n, name) for name, (*_, worlds) in CASES.items()
                                    for n in worlds])
def test_ring_attention_matches_reference(runs, n, name):
    want_out, want_grads = _reference(name, n)
    np.testing.assert_allclose(_joined(runs[n], name, "out"), want_out, rtol=0, atol=ATOL)
    for grad, got, want in zip(("dq", "dk", "dv"), _joined(runs[n], name, "grads"), want_grads):
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, err_msg=grad)


@pytest.mark.parametrize("n", WORLDS)
def test_ring_attention_shifts_k_and_v_together_n_minus_1_times(runs, n):
    """One shift a step, k and v in one node, the last step's rotation left
    out: n − 1 calls forward and n − 1 backward, each of one k and one v
    chunk."""
    (b, _, h_kv, chunk, d), *_ = CASES["causal"]
    for result in runs[n]:
        kv_bytes = 2 * b * h_kv * chunk * d * 4
        assert result["causal"]["counts"] == {"calls": {"seq": 2 * (n - 1)},
                                              "bytes": {"seq": 2 * (n - 1) * kv_bytes}}


@pytest.mark.parametrize("n", WORLDS)
def test_ring_shift_sends_forward_and_its_gradient_back(runs, n):
    """Rank c receives rank c − 1's tensors; its gradient goes to rank c − 1,
    so rank c's inputs get rank c + 1's weight. The float64 one travels
    with the float32 one in the same call; each message is tagged with the
    axis's running count."""
    for c, result in enumerate(runs[n]):
        shift = result["shift"]
        assert shift["received"] == [[float((c - 1) % n)] * 3, [[10.0 * ((c - 1) % n)] * 2] * 2]
        assert shift["grads"] == [[float((c + 1) % n + 1)] * 3, [[1.0] * 2] * 2]
        assert shift["counts"] == {"calls": {"seq": 2}, "bytes": {"seq": 2 * (3 * 4 + 4 * 8)}}
        assert shift["sent"]["seq"] >= 4  # 2 tensors each way, then the cases'


def test_reference_attention_matches_reference():
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(2, 3, 7, 8)).astype(np.float32) for _ in range(3))
    for causal in (True, False):
        want = np.asarray(jax_reference_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                                  causal=causal))
        got = tring.reference_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                        causal=causal)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_combine_chunks_matches_reference_and_ignores_empty_rows():
    """The lse merge, and a row that has seen no key (lse NEG_INF) weighing
    nothing: the port's NEG_INF is the reference's."""
    rng = np.random.default_rng(1)
    o1, o2 = (rng.normal(size=(2, 3, 5, 4)).astype(np.float32) for _ in range(2))
    l1, l2 = (rng.normal(size=(2, 3, 5)).astype(np.float32) for _ in range(2))
    l1[0, 0, 0] = NEG_INF
    want_o, want_l = jax_combine_chunks(*(jnp.asarray(x) for x in (o1, l1, o2, l2)))
    got_o, got_l = tring._combine_chunks(*(torch.from_numpy(x) for x in (o1, l1, o2, l2)))
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got_o[0, 0, 0].numpy(), o2[0, 0, 0])


def test_ring_attention_checks_the_head_counts():
    q, kv = torch.zeros(1, 3, 4, 8), torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match=r"q heads \(3\) must be a multiple of kv heads \(2\)"):
        tring.ring_attention(q, kv, kv, mesh=None)
