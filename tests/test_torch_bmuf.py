"""PyTorch port, multi-GPU slice: BMUF and local SGD against JAX's
``optim/bmuf.py`` and ``optim/local_sgd.py``.

The block filter's maths against JAX's ``BMUF`` on the same parameters at
every sync rule (warmup adoption, the filter with and without Nesterov
block momentum, block momentum 0); then two gloo ranks stepping a linear
least-squares model by the port's Adam through ``optim/local_sgd.py``
against JAX's ``LocalSGDBMUF`` with the same replicas on a 2-device mesh,
across two syncs, with ``--use-nbm`` and ``--average-sync``; then the
trainer's ``--use-bmuf``: no gradient all-reduce between the syncs. fp32 at
1e-5 of the largest entry."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fbk_fairseq_st_tpu.optim.bmuf import BMUF as JaxBMUF
from fbk_fairseq_st_tpu.optim.local_sgd import LocalSGDBMUF as JaxLocalSGDBMUF
from fbk_fairseq_st_tpu.optim.optimizers import Adam as JaxAdam
from fbk_fairseq_st_tpu.parallel.mesh import make_mesh as jax_make_mesh
from fbk_fairseq_st_tpu_torch.optim.bmuf import BMUF

from .test_torch_distributed import LSCE_ARGV, LSCE_UPDATES, VOCAB, jax_lsce
from .torch_dist import run_ranks
from .torch_shared import session_root, shared

LR = 0.01
VARIANTS = {
    "plain": dict(),
    "nbm": dict(use_nbm=True),
    "average_sync": dict(average_sync=True),
}


def _bmuf_args(**kw):
    return dict(dict(block_lr=0.7, block_momentum=0.875, global_sync_iter=2, warmup_iterations=2,
                     use_nbm=False, average_sync=False), **kw)


def _close(got, want, name=""):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(np.abs(want).max(), 1e-30), err_msg=name)


@pytest.mark.parametrize("kw", [dict(), dict(use_nbm=True), dict(block_momentum=0.0)], ids=["plain", "nbm", "off"])
def test_block_filter_matches_jax(kw):
    """Updates 1-8 with syncs at 2 (the warmup adoption), 4, 6 and 8: the
    filtered parameters equal JAX's ``BMUF.step`` at every update."""
    args = argparse.Namespace(**_bmuf_args(**kw))
    jbmuf, tbmuf = JaxBMUF(args), BMUF(args)
    rng = np.random.RandomState(0)
    shapes = {"w": (4, 3), "b": (3,)}
    for num_updates in range(1, 9):
        params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
        want = jbmuf.step({k: jnp.asarray(v) for k, v in params.items()}, num_updates)
        got = [torch.tensor(params[k]) for k in shapes]
        tbmuf.step(got, num_updates)
        for k, t in zip(shapes, got):
            _close(t.numpy(), np.asarray(want[k]), f"{k} update {num_updates}")


def _linear_case(seed=0, replicas=2, updates=4):
    rng = np.random.RandomState(seed)
    params = {"w": rng.randn(3).astype(np.float32), "b": np.float32(rng.randn())}
    batches = [{"x": rng.randn(replicas, 5, 3).astype(np.float32), "y": rng.randn(replicas, 5).astype(np.float32)}
               for _ in range(updates)]
    return params, batches


def _jax_local_sgd(variant):
    params, batches = _linear_case()
    args = argparse.Namespace(**_bmuf_args(**VARIANTS[variant]), adam_betas="(0.9, 0.999)", adam_eps=1e-8,
                              weight_decay=0.0)
    tx = optax.chain(JaxAdam.build_optimizer(args), optax.scale(-LR))

    def loss_fn(p, batch):
        return jnp.mean((batch["x"] @ p["w"] + p["b"] - batch["y"]) ** 2)

    runner = JaxLocalSGDBMUF(jax_make_mesh(devices=jax.devices()[:2]), tx, loss_fn,
                             {k: jnp.asarray(v) for k, v in params.items()}, args)
    history = []
    for batch in batches:
        runner.local_step({k: jnp.asarray(v) for k, v in batch.items()})
        history.append({k: np.asarray(v) for k, v in runner.params_r.items()})
    return params, batches, history


def _make(directory, lsce):
    jax_runs = {v: _jax_local_sgd(v) for v in VARIANTS}
    scenarios = [(v, dict(fn="local_sgd_linear", bmuf=_bmuf_args(**VARIANTS[v]), params=p, batches=b, lr=LR,
                          ranks=[0, 1])) for v, (p, b, _) in jax_runs.items()]
    scenarios.append(("trainer", dict(fn="bmuf_trainer", argv=LSCE_ARGV + ["--use-bmuf", "--global-sync-iter", "2",
                                                                          "--warmup-iterations", "3"],
                                      vocab=VOCAB, init_state=lsce["start"], updates=LSCE_UPDATES, ranks=[0, 1])))
    return {v: h for v, (_, _, h) in jax_runs.items()}, run_ranks(2, scenarios, directory)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = session_root(tmp_path_factory)
    lsce = shared(root, "torch_dist_jax_lsce", jax_lsce)
    return shared(root, "torch_bmuf", lambda directory: _make(directory, lsce))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_two_ranks_of_local_sgd_match_jax(runs, variant):
    """Four updates, syncs at 2 (warmup: the average adopted) and 4 (the
    block filter): each rank's parameters after every update equal JAX's
    replica of the same index; between syncs the two replicas differ, at
    a sync they agree."""
    want, ranks = runs
    for rank, history in enumerate(ranks[variant]):
        for step, ((w, b), jstep) in enumerate(zip(history, want[variant])):
            _close(w, jstep["w"][rank], f"w rank {rank} update {step + 1}")
            _close(b, jstep["b"][rank], f"b rank {rank} update {step + 1}")
    first, second = ranks[variant]
    assert not np.allclose(first[0][0], second[0][0])
    for step in (1, 3):
        np.testing.assert_array_equal(first[step][0], second[step][0])


def test_trainer_steps_locally_between_syncs(runs):
    """``--use-bmuf`` in the trainer (warmup sync at update 3): after
    updates 1 and 2 each rank's parameters are its own rows' updates by a
    trainer without a mesh (no gradient or statistic all-reduce; the
    first update's lr is 0); at update 3 both ranks hold the average of
    their two local models."""
    _, ranks = runs
    first, second = ranks["trainer"]
    for step in (0, 1):
        for rank in (first, second):
            for name, value in rank[step][1].items():
                _close(rank[step][0][name], value, f"{name} update {step + 1}")
    assert any(not np.allclose(first[1][0][n], second[1][0][n]) for n in first[1][0])
    for name in first[2][0]:
        np.testing.assert_array_equal(first[2][0][name], second[2][0][name])
        _close(first[2][0][name], (first[2][1][name] + second[2][1][name]) / 2, name)
