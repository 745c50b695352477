"""PyTorch port: the optimisers and schedulers against the JAX package's.

Each optimiser of ``fbk_fairseq_st_tpu/optim/optimizers.py`` (BMUF and
local SGD aside) takes 5 updates on the same seeded parameters and
gradients, lr from an inverse_sqrt schedule, once at its defaults and once
with weight decay: JAX through ``OPTIMIZERS[name].build_optimizer`` (optax,
``p -= lr * u``), the port through ``build_optimizer``; parameters at atol
1e-6 (fp32). The parameters include two weights whose two largest dims
reach 128, so Adafactor factors their second moments (one square). Each
scheduler runs 50 updates and 5 epochs with a val-loss sequence on both
sides, lr at relative 1e-12, and round-trips its ``state_dict``.
``optimizer_state_from_jax`` turns JAX's state after 3 updates into the
port's: the port's fourth update then equals JAX's, on a tree whose linear
weights are transposed and whose conv kernel is HWIO on the JAX side.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fbk_fairseq_st_tpu.registry import LR_SCHEDULERS as JAX_SCHEDULERS
from fbk_fairseq_st_tpu.registry import OPTIMIZERS as JAX_OPTIMIZERS
from fbk_fairseq_st_tpu_torch.optim import lr_schedulers as tsched
from fbk_fairseq_st_tpu_torch.optim import optimizers as topt
from fbk_fairseq_st_tpu_torch.utils.weights import fork_layout, optimizer_state_from_jax, state_dict_from_jax

OPTIMIZER_NAMES = ["adam", "adadelta", "adagrad", "adamax", "adafactor", "sgd", "nag", "lamb"]
ATOL = 1e-6


def _args(name, wd, **extra):
    """The parser defaults of each optimiser's add_args, with ``wd``."""
    parser = argparse.ArgumentParser()
    topt.OPTIMIZERS[name].add_args(parser)
    args = parser.parse_args([])
    args.optimizer, args.weight_decay = name, wd
    for k, v in extra.items():
        setattr(args, k, v)
    return args


def _lrs(n):
    sched = tsched.build_lr_scheduler(argparse.Namespace(lr=[2e-2], warmup_updates=3, warmup_init_lr=1e-3))
    return [sched.step_update(i) for i in range(n)]


def _params(rng):
    return {
        "big": rng.randn(128, 160).astype(np.float32) * 0.1,
        "square": rng.randn(128, 128).astype(np.float32) * 0.1,
        "w": rng.randn(4, 3).astype(np.float32),
        "b": rng.randn(3).astype(np.float32),
        "zero": np.zeros(5, np.float32),
    }


def _grads(rng, params, n):
    out = []
    for _ in range(n):
        g = {k: rng.randn(*v.shape).astype(np.float32) for k, v in params.items()}
        g["b"][0] = 0.0  # a sum of squares that stays 0 (scale_by_rss's where)
        out.append(g)
    return out


def _run_jax(tx, params, grads, lrs, state=None):
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp) if state is None else state
    for g, lr in zip(grads, lrs):
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, jax.tree_util.tree_map(lambda u: -lr * u, updates))
    return {k: np.asarray(v) for k, v in jp.items()}, state


def _run_port(opt, tp, grads, lrs):
    for g, lr in zip(grads, lrs):
        for k, p in tp.items():
            p.grad = torch.tensor(g[k])
        topt.set_lr(opt, lr)
        opt.step()


@pytest.mark.parametrize("wd", [0.0, 0.01], ids=["defaults", "weight_decay"])
@pytest.mark.parametrize("name", OPTIMIZER_NAMES)
def test_optimizer_matches_optax(name, wd):
    extra = {"momentum": 0.9} if name == "sgd" else {}
    args = _args(name, wd, **extra)
    rng = np.random.RandomState(4)
    params = _params(rng)
    grads = _grads(rng, params, 5)
    lrs = _lrs(5)
    want, _ = _run_jax(JAX_OPTIMIZERS[name].build_optimizer(args), params, grads, lrs)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt = topt.build_optimizer(args, list(tp.values()))
    _run_port(opt, tp, grads, lrs)
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), want[k], rtol=0, atol=ATOL, err_msg=k)
    if name == "adafactor":  # both big weights factored, the small ones not
        assert set(opt.state[tp["big"]]) == {"step", "v_row", "v_col"} == set(opt.state[tp["square"]])
        assert set(opt.state[tp["w"]]) == {"step", "v"}


def test_adafactor_with_beta1_and_sgd_without_momentum_match_optax():
    rng = np.random.RandomState(5)
    params = _params(rng)
    grads = _grads(rng, params, 5)
    lrs = _lrs(5)
    for name, extra in (("adafactor", {"beta1": 0.9}), ("sgd", {"momentum": 0.0})):
        args = _args(name, 0.0, **extra)
        want, _ = _run_jax(JAX_OPTIMIZERS[name].build_optimizer(args), params, grads, lrs)
        tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
        _run_port(topt.build_optimizer(args, list(tp.values())), tp, grads, lrs)
        for k in params:
            np.testing.assert_allclose(tp[k].detach().numpy(), want[k], rtol=0, atol=ATOL, err_msg=(name, k))


def test_unported_optimizers_raise():
    for name in ("bmuf", "no_such_optimizer"):
        with pytest.raises(NotImplementedError):
            topt.build_optimizer(argparse.Namespace(optimizer=name), [torch.zeros(1, requires_grad=True)])


# ---------------------------------------------------------------------------
# schedulers
# ---------------------------------------------------------------------------

SCHEDULES = {
    "fixed": dict(lr=[0.5, 0.3, 0.2], warmup_updates=5, force_anneal=3, lr_shrink=0.5),
    "fixed_no_anneal": dict(lr=[0.25, 0.2], warmup_updates=0, force_anneal=None, lr_shrink=0.1),
    "inverse_sqrt": dict(lr=[2e-3], warmup_updates=10, warmup_init_lr=-1.0),
    "cosine": dict(lr=[1e-4], max_lr=1e-2, warmup_updates=5, warmup_init_lr=-1.0, t_mult=1.5,
                   lr_period_updates=12, lr_shrink=0.5, max_update=0),
    "polynomial_decay": dict(lr=[1e-2], warmup_updates=7, end_learning_rate=1e-4, power=2.0,
                             total_num_update=40, force_anneal=None),
    "reduce_lr_on_plateau": dict(lr=[1e-2], lr_shrink=0.5, lr_threshold=1e-4, lr_patience=0, warmup_updates=4,
                                 warmup_init_lr=1e-4),
    "tri_stage": dict(lr=[1e-2], warmup_steps=8, hold_steps=10, decay_steps=20, init_lr_scale=0.01,
                      final_lr_scale=0.05),
    "triangular": dict(lr=[1e-4], max_lr=1e-2, lr_period_updates=16, lr_shrink=0.5, shrink_min=True),
}
VAL_LOSSES = [5.0, 4.0, 4.2, 4.19995, 3.0]


def _sched_pair(case):
    name = case.replace("_no_anneal", "")
    cfg = SCHEDULES[case]
    jsched = JAX_SCHEDULERS[name].build_lr_scheduler(argparse.Namespace(lr_scheduler=name, **cfg))
    tsch = tsched.build_lr_scheduler(argparse.Namespace(lr_scheduler=name, **cfg))
    return jsched, tsch


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_scheduler_matches_jax(case):
    """50 updates over 5 epochs, ``step(epoch, val_loss)`` at each epoch's
    end: every lr within relative 1e-12."""
    jsched, tsch = _sched_pair(case)
    got, want = [], []
    for epoch in range(1, 6):
        for i in range(10):
            u = (epoch - 1) * 10 + i
            want.append(jsched.step_update(u))
            got.append(tsch.step_update(u))
        want.append(jsched.step(epoch, VAL_LOSSES[epoch - 1]))
        got.append(tsch.step(epoch, VAL_LOSSES[epoch - 1]))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert len(set(np.round(got, 15))) > 1


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_scheduler_state_dict_round_trip(case):
    """The state after 2 epochs is what JAX's scheduler saves; restored
    into a new scheduler, it gives the first's lr at every later update,
    and at each epoch's end what JAX's restored scheduler gives (the
    polynomial schedule's warmup factor is not in its state, in JAX too)."""
    jsched, a = _sched_pair(case)
    jb, b = _sched_pair(case)
    for epoch in (1, 2):
        for u in range((epoch - 1) * 10, epoch * 10):
            a.step_update(u)
            jsched.step_update(u)
        a.step(epoch, VAL_LOSSES[epoch - 1])
        jsched.step(epoch, VAL_LOSSES[epoch - 1])
    assert a.state_dict() == jsched.state_dict()
    b.load_state_dict(a.state_dict())
    jb.load_state_dict(jsched.state_dict())
    for epoch in (3, 4):
        for u in range((epoch - 1) * 10, epoch * 10):
            assert b.step_update(u) == a.step_update(u) == jb.step_update(u)
        a.step(epoch, VAL_LOSSES[epoch - 1])
        assert b.step(epoch, VAL_LOSSES[epoch - 1]) == jb.step(epoch, VAL_LOSSES[epoch - 1])
    assert b.state_dict() == jb.state_dict()


# ---------------------------------------------------------------------------
# optimizer_state_from_jax
# ---------------------------------------------------------------------------

def _jax_tree(rng):
    """A params tree in the JAX layout: transposed linears (one square, one
    factored by Adafactor with the larger dim on the other side), an HWIO
    conv kernel, a bias and an embedding table."""
    return {
        "encoder": {
            "layers": [{"self_attn": {"q": {"w": rng.randn(128, 128).astype(np.float32) * 0.1,
                                            "b": rng.randn(128).astype(np.float32)}},
                        "fc1": {"w": rng.randn(128, 160).astype(np.float32) * 0.1}}],
            "frontend": {"convs": [{"w": rng.randn(3, 3, 2, 4).astype(np.float32)}]},
        },
        "decoder": {"embed_tokens": {"weight": rng.randn(6, 4).astype(np.float32)}},
    }


class _Holder(torch.nn.Module):
    """A module whose parameters carry the given dotted names."""

    def __init__(self, state_dict):
        super().__init__()
        for name, value in state_dict.items():
            mod = self
            *path, leaf = name.split(".")
            for part in path:
                if not hasattr(mod, part):
                    mod.add_module(part, torch.nn.Module())
                mod = getattr(mod, part)
            mod.register_parameter(leaf, torch.nn.Parameter(value.clone()))


@pytest.mark.parametrize("wd", [0.0, 0.01], ids=["defaults", "weight_decay"])
@pytest.mark.parametrize("name", OPTIMIZER_NAMES)
def test_optimizer_state_from_jax(name, wd):
    """JAX's state after 3 updates -> the port's; the port's fourth update
    from JAX's third parameters equals JAX's fourth (atol 1e-6)."""
    extra = {"momentum": 0.9} if name == "sgd" else {"beta1": 0.9} if name == "adafactor" else {}
    args = _args(name, wd, **extra)
    rng = np.random.RandomState(6)
    tree = _jax_tree(rng)
    grads = [jax.tree_util.tree_map(lambda x: rng.randn(*x.shape).astype(np.float32), tree) for _ in range(4)]
    lrs = _lrs(4)
    tx = JAX_OPTIMIZERS[name].build_optimizer(args)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    state = tx.init(params)
    for g, lr in zip(grads, lrs):
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, params)
        params = optax.apply_updates(params, jax.tree_util.tree_map(lambda u: -lr * u, updates))
        if lr == lrs[2]:
            third_params = jax.tree_util.tree_map(np.asarray, params)
            third_state = jax.tree_util.tree_map(np.asarray, state)
    model = _Holder(state_dict_from_jax({"params": third_params}))
    opt = topt.build_optimizer(args, list(model.parameters()))
    opt.load_state_dict(optimizer_state_from_jax(third_state, third_params, model, opt))
    for pname, p in model.named_parameters():
        p.grad = state_dict_from_jax({"params": grads[3]})[pname]
    topt.set_lr(opt, lrs[3])
    opt.step()
    want = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, params)})
    for pname, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[pname].numpy(), rtol=0, atol=ATOL, err_msg=pname)
    if name == "adafactor":
        square = opt.state[dict(model.named_parameters())["encoder.layers.0.self_attn.q_proj.weight"]]
        assert square["v_row"].shape == (128,) and int(square["step"]) == 4


def test_fork_layout_of_a_conv_kernel():
    arr = np.arange(3 * 3 * 2 * 4).reshape(3, 3, 2, 4)
    assert fork_layout("encoder.frontend.convs.0.weight", arr).shape == (4, 2, 3, 3)
