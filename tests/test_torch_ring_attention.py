"""PyTorch port, multi-GPU slice: ring attention on the flash kernels'
block route against JAX's ``ring_attention`` on its 8-device CPU mesh.

The cases are JAX's own (tests/test_ring_attention.py::_case_params: ring
sizes 2 and 4, causal or not, keys padded from 11 of 16 or not), forward
and the gradients of sum(o * w) + sum(o^2) in q, k and v. The port runs
them two ways: ``ring_attention_shards`` (the shards held in one process,
the rotation an index; the card's check runs this route) and the ring's
autograd Function over 2 and 4 gloo ranks (the rotation a batch of
point-to-point sends). On the CPU each block is the flash kernels' plain
versions. Then ``MultiheadAttention`` with its ring set equals its own
dense route. fp32 at 1e-5 of the largest entry (JAX's own test holds its
ring to its dense attention at 1e-5 and 2e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbk_fairseq_st_tpu.ops.ring_attention import ring_attention
from fbk_fairseq_st_tpu_torch.ops import ring_attention as tring

from .test_ring_attention import _case_params, _inputs, _mesh
from .torch_dist import run_ranks
from .torch_shared import session_root, shared

SCALE = 0.5
CASES = [tuple(p.values) for p in _case_params()]


def _jax_case(ring_size, causal, pad_from):
    q, k, v, bias = _inputs(pad_from=pad_from, seed=1)
    w = jax.random.normal(jax.random.PRNGKey(9), q.shape, jnp.float32)
    mesh = _mesh(ring_size)

    def loss(q, k, v):
        o = ring_attention(q, k, v, bias, SCALE, mesh, axis="model", causal=causal)
        return jnp.sum(o * w) + jnp.sum(o ** 2), o

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    arrays = [np.asarray(x) for x in (q, k, v, bias, w)]
    return arrays, {"out": np.asarray(out), **{f"d{n}": np.asarray(g) for n, g in zip("qkv", grads)}}


def _close(got, want, name):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max(), err_msg=name)


def _make(directory):
    jax_cases = {case: _jax_case(*case) for case in CASES}
    by_size = {n: [(q, k, v, bias, w, SCALE, causal) for (size, causal, _), ((q, k, v, bias, w), _)
                   in jax_cases.items() if size == n] for n in (2, 4)}
    rng = np.random.RandomState(0)
    mha_state = {name: rng.randn(*shape).astype(np.float32) * 0.3 for name, shape in
                 (("q_proj.weight", (16, 16)), ("q_proj.bias", (16,)), ("k_proj.weight", (16, 16)),
                  ("k_proj.bias", (16,)), ("v_proj.weight", (16, 16)), ("v_proj.bias", (16,)),
                  ("out_proj.weight", (16, 16)), ("out_proj.bias", (16,)))}
    x = rng.randn(3, 16, 16).astype(np.float32)
    kpm = np.zeros((3, 16), bool)
    kpm[:, 13:] = True
    kpm[2, :] = True  # a row whose every key is padding: the dense route's uniform average
    ranks = run_ranks(4, [
        ("ring2", dict(fn="ring", cases=by_size[2], ranks=[0, 1])),
        ("ring4", dict(fn="ring", cases=by_size[4], ranks=[0, 1, 2, 3])),
        ("mha", dict(fn="mha_ring", cfg=(16, 2), state=mha_state, x=x, kpm=kpm, ranks=[0, 1])),
    ], directory)
    return jax_cases, ranks


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return shared(session_root(tmp_path_factory), "torch_ring_attention", _make)


@pytest.mark.parametrize("ring_size,causal,pad_from", CASES)
def test_shards_in_one_process_match_jax_ring(runs, ring_size, causal, pad_from):
    """``ring_attention_shards`` and its backward over the shards held in
    one process equal JAX's ring on the mesh."""
    jax_cases, _ = runs
    (q, k, v, bias, w), want = jax_cases[(ring_size, causal, pad_from)]
    split = [list(torch.tensor(a).chunk(ring_size, dim=1)) for a in (q, k, v, bias, w)]
    outs, lses = tring.ring_attention_shards(*split[:4], SCALE, causal)
    grads = [wl + 2 * o for wl, o in zip(split[4], outs)]
    dqs, dks, dvs = tring.ring_attention_shards_backward(*split[:4], outs, lses, grads, SCALE, causal)
    for name, parts in (("out", outs), ("dq", dqs), ("dk", dks), ("dv", dvs)):
        _close(torch.cat(parts, dim=1).numpy(), want[name], name)


@pytest.mark.parametrize("ring_size,causal,pad_from", CASES)
def test_ranks_match_jax_ring(runs, ring_size, causal, pad_from):
    """The ring's autograd Function over 2 and 4 gloo ranks (K/V blocks
    sent round the ring, dK/dV sent back to their owner) equals JAX's
    ring, forward and gradients; every rank gathers the same."""
    jax_cases, ranks = runs
    _, want = jax_cases[(ring_size, causal, pad_from)]
    index = [c for c in CASES if c[0] == ring_size].index((ring_size, causal, pad_from))
    results = [r for r in ranks[f"ring{ring_size}"] if r is not None]
    assert len(results) == ring_size
    for name in ("out", "dq", "dk", "dv"):
        for r in results:
            _close(r[index][name], want[name], name)


def test_mha_with_the_ring_equals_its_dense_route(runs):
    """``MultiheadAttention`` (16 wide, 2 heads, T 16, keys padded from 13,
    one row all padding) with its ring over 2 ranks: the output and the
    input's gradient equal the module's dense route, causal and not."""
    _, ranks = runs
    for r in ranks["mha"][:2]:
        for mask in (None, "causal"):
            dense, ring = r[(mask, False)], r[(mask, True)]
            for got, want, name in zip(ring, dense, ("out", "dx")):
                _close(got, want, f"{name} {mask}")


@pytest.mark.parametrize("n", [2, 4])
def test_block_schedule(n):
    """N^2 blocks without a causal mask; N(N+1)/2 with one: earlier shards
    full, the own shard's diagonal causal, later shards skipped."""
    modes = [tring.visit(r, s, causal=True) for r in range(n) for s in range(n)]
    assert sum(m is not None for m in modes) == n * (n + 1) // 2
    assert sum(m is True for m in modes) == n
    assert all(tring.visit(r, s, causal=False) is False for r in range(n) for s in range(n))
    assert tring.ring_eligible(16, 16, n) and not tring.ring_eligible(16, 12, n)
    assert not tring.ring_eligible(2 * n - 1, 2 * n - 1, n)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_dropout_is_its_blocks_masks(causal):
    """With attention dropout (rate 0.3) the ring's output and gradients
    equal dense attention whose keep mask is, block by block, the Philox
    mask of that block's seed (``block_seed``: seed, q shard, k shard), so
    forward and backward draw the same bits; key padding from 11 of 16."""
    from fbk_fairseq_st_tpu_torch.ops.kernels import philox

    n, rate, seed = 2, 0.3, 1234
    q, k, v, bias = (torch.tensor(np.asarray(a)) for a in _inputs(bh=3, t=16, d=4, pad_from=11, seed=2))
    w = torch.randn(q.shape, generator=torch.Generator().manual_seed(3))
    t = q.shape[1]
    loc = t // n
    keep = torch.ones(q.shape[0], t, t)
    for r in range(n):
        for s in range(n):
            keep[:, r * loc:(r + 1) * loc, s * loc:(s + 1) * loc] = philox.keep_mask(
                tring.block_seed(seed, r, s, n), q.shape[0], loc, loc, rate).float()
    qd, kd, vd = (x.clone().requires_grad_(True) for x in (q, k, v))
    scores = torch.einsum("btd,bsd->bts", qd, kd) * SCALE + bias[:, None, :]
    if causal:
        scores = torch.where(torch.ones(t, t, dtype=torch.bool).tril(), scores, -1e9)
    dense = torch.einsum("bts,bsd->btd", torch.softmax(scores, -1) * keep / (1 - rate), vd)
    ((dense * w).sum() + (dense ** 2).sum()).backward()
    split = [list(x.chunk(n, dim=1)) for x in (q, k, v, bias, w)]
    outs, lses = tring.ring_attention_shards(*split[:4], SCALE, causal, rate, seed)
    grads = [wl + 2 * o for wl, o in zip(split[4], outs)]
    dqs, dks, dvs = tring.ring_attention_shards_backward(*split[:4], outs, lses, grads, SCALE, causal, rate, seed)
    for name, got, want in (("out", outs, dense), ("dq", dqs, qd.grad), ("dk", dks, kd.grad), ("dv", dvs, vd.grad)):
        _close(torch.cat(got, dim=1).numpy(), want.detach().numpy(), name)
