"""PyTorch port, training slice: the flash backward, the Philox dropout,
the loss, the schedule, Adam and whole train steps against the JAX
package on the same numpy inputs, on the CPU.

The port runs its plain versions here (CPU tensors): the flash route goes
through the same autograd Function as on the card, with the dense
backward formulas of the kernels. JAX runs its Pallas kernels in
interpret mode, as its own tests do. Dropout cannot match JAX bit for bit
(other random bits), so whole-step parity runs in the deterministic mode
of tests/test_corpus_parity.py (criterion forced to ``training=False``),
and dropout is held to its own statistics and to gradcheck. Tolerances
are stated per test; everything is fp32 unless a test says otherwise."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fbk_fairseq_st_tpu import options, registry
from fbk_fairseq_st_tpu.criterions import label_smoothed_cross_entropy as jlsce
from fbk_fairseq_st_tpu.ops import attention as jattn
from fbk_fairseq_st_tpu.ops.pallas import attention_kernel as jkern
from fbk_fairseq_st_tpu.optim.optimizers import Adam as JaxAdam
from fbk_fairseq_st_tpu.registry import LR_SCHEDULERS
from fbk_fairseq_st_tpu.train.trainer import Trainer as JaxTrainer
from fbk_fairseq_st_tpu_torch.criterions import label_smoothed_cross_entropy as tlsce
from fbk_fairseq_st_tpu_torch.models import conv_transformer as tct
from fbk_fairseq_st_tpu_torch.ops import attention as tattn
from fbk_fairseq_st_tpu_torch.ops.kernels import flash_attention as tflash
from fbk_fairseq_st_tpu_torch.ops.kernels import philox
from fbk_fairseq_st_tpu_torch.optim import lr_schedulers as tsched
from fbk_fairseq_st_tpu_torch.optim import optimizers as topt
from fbk_fairseq_st_tpu_torch.tasks import SpeechRecognitionTask
from fbk_fairseq_st_tpu_torch.train import Trainer
from fbk_fairseq_st_tpu_torch.utils.weights import state_dict_from_jax

from .test_torch_model import SMALL, VOCAB, torch_dictionary
from .test_torch_ops import FLASH_CASES, _flash_inputs
from .utils import DummyTask, dummy_dictionary


def _np(x):
    return np.asarray(x.detach()) if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture
def flash_routes():
    def set_both(enabled):
        jattn.set_flash_attention(enabled)
        tattn.set_flash_attention(enabled)
    yield set_both
    jattn.set_flash_attention(None)
    tattn.set_flash_attention(None)


# ---------------------------------------------------------------------------
# flash backward
# ---------------------------------------------------------------------------

def _padded_for_jax(q, k, v, bias, g):
    """The inputs as JAX's flash_attention pads them: T and S to x128, the
    padded keys masked with NEG_INF."""
    t, s = q.shape[1], k.shape[1]
    tp, sp = jkern._pad_to(t), jkern._pad_to(s)
    pad = lambda x, n: np.pad(x, ((0, 0), (0, n - x.shape[1]), (0, 0)))  # noqa: E731
    bp = np.pad(bias, ((0, 0), (0, sp - s)), constant_values=-1e9)
    return [jnp.asarray(x) for x in (pad(q, tp), pad(k, sp), pad(v, sp), bp, pad(g, tp))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["fused", "split"])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_backward_reference_matches_jax_kernels(case, impl, dtype):
    """flash_attention_backward_reference against JAX's _bwd_fused_impl /
    _bwd_impl (interpret mode, rate 0) on the same out and lse: dq, dk, dv.
    fp32 at atol 2e-5. bf16 (q, k, v, dO and JAX's out in bf16) within half
    a bf16 ulp of the largest gradient, 2^-9 max|grad|: the plain version
    rounds ds and w_v to bf16 before the products as the Pallas kernels'
    .astype does, and then matches them here to the bit, where without the
    rounding it differed by one bf16 ulp of the largest gradients (up to
    3.1e-2 at |grad| ~ 6, this host)."""
    bh, t, s, d, causal, padded = FLASH_CASES[case]
    q, k, v, bias = _flash_inputs(bh, t, s, d, padded)
    g = np.random.RandomState(1).randn(bh, t, d).astype(np.float32)
    scale = 0.7
    qp, kp, vp, bp, gp = _padded_for_jax(q, k, v, bias, g)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    qp, kp, vp, gp = (x.astype(jdt) for x in (qp, kp, vp, gp))
    seed = jnp.zeros((1,), jnp.int32)
    blocks = dict(causal=causal, scale=scale, rate=0.0, t_block=qp.shape[1], s_block=kp.shape[1],
                  interpret=True)
    out, lse = jkern._fwd_impl(qp, kp, vp, bp, seed, **blocks)
    bwd = jkern._bwd_fused_impl if impl == "fused" else jkern._bwd_impl
    want = bwd(qp, kp, vp, bp, seed, out, lse, gp, **blocks)
    as_port = lambda x, n: torch.tensor(np.asarray(x.astype(jnp.float32))[:, :n]).to(tdt)  # noqa: E731
    got = tflash.flash_attention_backward_reference(
        as_port(qp, t), as_port(kp, s), as_port(vp, s), torch.tensor(bias), as_port(out, t),
        torch.tensor(np.asarray(lse)[:, 0, :t]), as_port(gp, t), scale, causal)
    for name, a, b, n in zip(("dq", "dk", "dv"), got, want, (t, s, s)):
        assert a.dtype == tdt
        b = np.asarray(b.astype(jnp.float32))[:, :n]
        atol = 2e-5 if dtype == "float32" else 2.0 ** -9 * np.abs(b).max()
        np.testing.assert_allclose(_np(a.float()), b, rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_grads_match_jax_grad(case):
    """Autograd through the port's flash_attention (the autograd Function,
    plain route) against jax.grad of JAX's flash_attention (Pallas
    interpret): q, k and v gradients at atol 2e-5, D = 20 and causal
    T != S included."""
    bh, t, s, d, causal, padded = FLASH_CASES[case]
    q, k, v, bias = _flash_inputs(bh, t, s, d, padded, seed=2)
    g = np.random.RandomState(3).randn(bh, t, d).astype(np.float32)
    scale = 0.6

    def loss(q, k, v):
        return jnp.sum(jkern.flash_attention(q, k, v, jnp.asarray(bias), scale, causal=causal) * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = tflash.flash_attention(tq, tk, tv, torch.tensor(bias), scale, causal=causal)
    out.backward(torch.tensor(g))
    for name, a, b in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0, atol=2e-5, err_msg=name)


# ---------------------------------------------------------------------------
# Philox dropout
# ---------------------------------------------------------------------------

# Random123's known-answer vectors for philox4x32_10: (counter, key, output)
PHILOX_KAT = {
    "zeros": ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    "ones": ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    "pi": ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
           (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
}


@pytest.mark.parametrize("name", sorted(PHILOX_KAT))
def test_philox_known_answers(name):
    counter, key, want = PHILOX_KAT[name]
    got = philox.philox4x32_10(*(torch.tensor(c, dtype=torch.int64) for c in counter), *key)
    assert tuple(int(w) for w in got) == want


def test_keep_mask_is_keyed_per_element():
    """Element (bh, i, j) takes word j % 4 of counter (j // 4, i, bh, 0)
    under key (seed lo, seed hi), whatever the shape it is drawn in."""
    seed = 0x0123456789ABCDEF
    bits = philox.random_bits(seed, 3, 10, 13)
    for bh, i, j in [(0, 0, 0), (2, 9, 12), (1, 4, 7), (2, 0, 5)]:
        words = philox.philox4x32_10(*(torch.tensor(c) for c in (j // 4, i, bh, 0)),
                                     seed & 0xFFFFFFFF, seed >> 32)
        assert int(bits[bh, i, j]) == int(words[j % 4])
    torch.testing.assert_close(philox.random_bits(seed, 2, 6, 5), bits[:2, :6, :5], rtol=0, atol=0)
    assert philox.keep_threshold(0.0) == 0 and philox.keep_threshold(0.25) == 2 ** 30


@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_keep_rate_within_binomial_bounds(rate):
    """The keep fraction of 8 x 64 x 128 draws lies within 5 standard
    deviations of 1 - rate, for two seeds, and the seeds differ."""
    n = 8 * 64 * 128
    sd = (rate * (1 - rate) / n) ** 0.5
    masks = [philox.keep_mask(seed, 8, 64, 128, rate) for seed in (1, 2 ** 40 + 7)]
    for m in masks:
        assert abs(m.float().mean().item() - (1 - rate)) < 5 * sd
    assert not torch.equal(masks[0], masks[1])


def test_dropout_is_linear_in_v():
    """With the seed fixed the mask does not depend on V: out(V1 + V2) =
    out(V1) + out(V2) at atol 1e-5, and out differs from the undropped
    output."""
    q, k, v1, bias = map(torch.tensor, _flash_inputs(3, 9, 12, 8, True, seed=4))
    v2 = torch.randn(v1.shape, generator=torch.Generator().manual_seed(5))
    f = lambda v: tflash.flash_attention(q, k, v, bias, 0.5, dropout_rate=0.3, dropout_seed=99)  # noqa: E731
    torch.testing.assert_close(f(v1 + v2), f(v1) + f(v2), rtol=0, atol=1e-5)
    assert (f(v1) - tflash.flash_attention(q, k, v1, bias, 0.5)).abs().max() > 1e-2


@pytest.mark.parametrize("causal", [False, True])
def test_dropout_backward_replays_the_forward_mask(causal):
    """gradcheck in float64 on the plain route at rate 0.3 with a fixed
    seed: the analytic backward (the kernels' formulas) agrees with finite
    differences of the dropped forward, so it replays the same mask."""
    rng = np.random.RandomState(6)
    q, k, v = (torch.tensor(rng.randn(2, 6, 4), requires_grad=True) for _ in range(3))
    bias = torch.zeros(2, 6, dtype=torch.float64)
    bias[1, 4:] = -1e9
    assert torch.autograd.gradcheck(
        lambda a, b, c: tflash.flash_attention(a, b, c, bias, 0.8, causal=causal,
                                               dropout_rate=0.3, dropout_seed=1234),
        (q, k, v),
    )


# ---------------------------------------------------------------------------
# loss, schedule, optimizer
# ---------------------------------------------------------------------------

def _logits_and_targets(seed=7, pad=1):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(3, 5, 11) * 2).astype(np.float32)
    target = rng.randint(2, 11, size=(3, 5))
    target[1, 3:] = pad
    target[2, 1:] = pad
    return logits, target


def test_label_smoothed_loss_forms_match_jax():
    """Both forms (from logits; from log-softmax) against JAX's, with pads
    ignored: loss and nll at rtol 1e-6."""
    logits, target = _logits_and_targets()
    want = jlsce.label_smoothed_nll_from_logits(jnp.asarray(logits), jnp.asarray(target), 0.1, ignore_index=1)
    got = tlsce.label_smoothed_nll_from_logits(torch.tensor(logits), torch.tensor(target), 0.1, ignore_index=1)
    lp = jax.nn.log_softmax(jnp.asarray(logits), axis=-1).reshape(-1, 11)
    want_lp = jlsce.label_smoothed_nll_loss(lp, jnp.asarray(target).reshape(-1), 0.1, ignore_index=1)
    got_lp = tlsce.label_smoothed_nll_loss(torch.log_softmax(torch.tensor(logits), -1).reshape(-1, 11),
                                           torch.tensor(target).reshape(-1), 0.1, ignore_index=1)
    for a, b in list(zip(got, want)) + list(zip(got_lp, want_lp)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6)


@pytest.mark.parametrize("warmup_init_lr", [-1.0, 1e-7])
def test_inverse_sqrt_matches_jax(warmup_init_lr):
    """Exactly the JAX schedule (rtol 1e-12) at steps 0, 1, warmup - 1,
    warmup and 10 * warmup; with the default init lr the first is 0."""
    warmup = 40
    jargs = argparse.Namespace(lr=[2e-3], warmup_updates=warmup, warmup_init_lr=warmup_init_lr)
    targs = argparse.Namespace(lr=[2e-3], warmup_updates=warmup, warmup_init_lr=warmup_init_lr)
    jsched = LR_SCHEDULERS["inverse_sqrt"].build_lr_scheduler(jargs)
    tsch = tsched.build_lr_scheduler(targs)
    for step in (0, 1, warmup - 1, warmup, 10 * warmup):
        np.testing.assert_allclose(tsch.step_update(step), jsched.step_update(step), rtol=1e-12)
    if warmup_init_lr < 0:
        assert tsch.step_update(0) == 0.0


def test_adam_with_weight_decay_matches_optax():
    """Two updates of the port's Adam (coupled weight decay, lr applied as
    p -= lr * u) against optax's scale_by_adam behind add_decayed_weights,
    as the JAX package builds it: params at atol 1e-7."""
    args = argparse.Namespace(optimizer="adam", adam_betas="(0.9, 0.98)", adam_eps=1e-8, weight_decay=0.01)
    rng = np.random.RandomState(8)
    params = {"w": rng.randn(4, 3).astype(np.float32), "b": rng.randn(3).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in params.items()} for _ in range(2)]
    lrs = [1e-3, 2e-3]

    tx = JaxAdam.build_optimizer(args)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt = topt.build_optimizer(args, list(tp.values()))
    for g, lr in zip(grads, lrs):
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, jax.tree_util.tree_map(lambda u: -lr * u, updates))
        for k, p in tp.items():
            p.grad = torch.tensor(g[k])
        topt.set_lr(opt, lr)
        opt.step()
    for k in params:
        np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k]), rtol=0, atol=1e-7, err_msg=k)


# ---------------------------------------------------------------------------
# the whole slice
# ---------------------------------------------------------------------------

TRAIN_ARGV = [
    "/nonexistent", "--task", "speech_recognition", "-t", "de",
    "--arch", "conv_transformer",
    "--criterion", "label_smoothed_cross_entropy", "--label-smoothing", "0.1",
    "--optimizer", "adam", "--adam-betas", "(0.9, 0.98)", "--weight-decay", "0.0001",
    "--lr", "0.002", "--lr-scheduler", "inverse_sqrt", "--warmup-updates", "2",
    "--clip-norm", "10.0", "--max-tokens", "4000", "--distributed-world-size", "1",
] + [f"--{k.replace('_', '-')}={v}" for k, v in SMALL.items()]


class _DeterministicJaxLSCE(jlsce.LabelSmoothedCrossEntropyCriterion):
    def __call__(self, model, variables, batch, rng=None, training=False):
        return super().__call__(model, variables, batch, rng=rng, training=False)


class _DeterministicLSCE(tlsce.LabelSmoothedCrossEntropyCriterion):
    def __call__(self, model, batch, generator=None, training=False):
        return super().__call__(model, batch, generator, training=False)


def _train_sample(seed, b=3, t=37, tgt_len=7):
    rng = np.random.RandomState(seed)
    lengths = np.array([t, t - 8, t - 15][:b], np.int32)
    tokens = rng.randint(4, VOCAB, size=(b, tgt_len)).astype(np.int32)
    tokens[-1, -2:] = 1  # padded target tail
    target = tokens.copy()
    prev = np.concatenate([np.full((b, 1), 2, np.int32), tokens[:, :-1]], axis=1)
    return {
        "net_input": {
            "src_tokens": rng.randn(b, t, SMALL["input_feat_per_channel"]).astype(np.float32),
            "src_lengths": lengths,
            "prev_output_tokens": prev,
        },
        "target": target,
        "ntokens": int((target != 1).sum()),
        "nsentences": b,
    }


def _trainer_pair():
    """A JAX Trainer and the port's Trainer on the same initial weights,
    both with the deterministic criterion."""
    args = options.parse_args_and_arch(options.get_training_parser(), TRAIN_ARGV)
    jd = dummy_dictionary(VOCAB)
    jtask = DummyTask(jd)
    jmodel = registry.build_model(args, jtask)
    jtrainer = JaxTrainer(args, jtask, jmodel, _DeterministicJaxLSCE(
        jtask, argparse.Namespace(label_smoothing=0.1, sentence_avg=False)))
    gnorms = []
    log_training = jtrainer._log_training
    jtrainer._log_training = lambda lo, gnorm, meta: (gnorms.append(gnorm), log_training(lo, gnorm, meta))

    td = torch_dictionary()
    ttask = SpeechRecognitionTask(args, td)
    tmodel = ttask.build_model(args, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jtrainer.variables())), strict=True)
    ttrainer = Trainer(args, ttask, tmodel, _DeterministicLSCE(ttask, args))
    return jtrainer, gnorms, ttrainer


@pytest.mark.parametrize("route,update_freq", [("dense", 1), ("flash", 1), ("dense", 2)])
def test_train_steps_match_jax_trainer(route, update_freq, flash_routes):
    """Three train steps of the port's Trainer against JAX's Trainer
    (warmup 2, so lr > 0 from the second step; weight decay on): per-step
    loss, nll_loss and gnorm at rtol 1e-5, then every parameter and
    BatchNorm buffer at atol 1e-5. JAX's flash route runs its Pallas
    forward and fused backward in interpret mode, the port's its autograd
    Function on the plain versions.

    The attention key-projection biases are the exception: their exact
    gradient is 0 (they shift every score of a query row alike, which the
    softmax cancels), so each side's Adam normalises its own rounding
    noise into steps of up to lr. They are held to 2 x the summed lr."""
    flash_routes(route == "flash")
    jtrainer, jgnorms, ttrainer = _trainer_pair()
    lr_sum = 0.0
    for step in range(3):
        lr_sum += jtrainer.lr_scheduler.step_update(step)
        samples = [_train_sample(10 * step + i) for i in range(update_freq)]
        want = jtrainer.train_step(samples)
        got = ttrainer.train_step(samples)
        for key in ("loss", "nll_loss"):
            np.testing.assert_allclose(float(got[key]), want[key], rtol=1e-5, err_msg=f"{key} step {step}")
        assert int(got["ntokens"]) == want["ntokens"] and int(got["sample_size"]) == want["sample_size"]
        np.testing.assert_allclose(float(got["gnorm"]), jgnorms[step], rtol=1e-5, err_msg=f"gnorm step {step}")
        assert float(got["lr"]) == pytest.approx(jtrainer.lr_scheduler.step_update(step), rel=1e-7)
    assert ttrainer.get_num_updates() == jtrainer.get_num_updates() == 3
    want_sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jtrainer.variables()))
    got_sd = ttrainer.model.state_dict()
    assert sorted(got_sd) == sorted(want_sd)
    for name, value in want_sd.items():
        atol = 2 * lr_sum if name.endswith("k_proj.bias") else 1e-5
        np.testing.assert_allclose(_np(got_sd[name]), value.numpy(), rtol=0, atol=atol, err_msg=name)


def test_train_mode_on_the_cpu_learns_with_dropout(flash_routes):
    """Five train steps with dropout on (flash route, so the in-kernel
    dropout's plain version and its backward run inside the model) on a
    fixed batch: the loss is finite and falls, and the BatchNorm running
    stats move."""
    flash_routes(True)
    args = options.parse_args_and_arch(options.get_training_parser(), TRAIN_ARGV)
    args.warmup_updates, args.lr = 1, [5e-3]
    task = SpeechRecognitionTask(args, torch_dictionary())
    model = task.build_model(args, device="cpu")
    trainer = Trainer(args, task, model, task.build_criterion(args))
    bn_before = model.encoder.bn[0].running_mean.clone()
    sample = _train_sample(0)
    losses = [float(trainer.train_step([sample])["loss"]) for _ in range(5)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
    assert not torch.allclose(model.encoder.bn[0].running_mean, bn_before)


def test_off_path_training_options_raise():
    args = options.parse_args_and_arch(options.get_training_parser(), TRAIN_ARGV)
    # SpecAugment and the JSON route are ported: a
    # split without its <split>.json is missing
    with pytest.raises(FileNotFoundError, match="no data found for split train"):
        SpeechRecognitionTask(argparse.Namespace(**{**vars(args), "dataset_from_json": True, "data": "/nonexistent"}),
                              torch_dictionary()).load_dataset("train")
    task = SpeechRecognitionTask(args, torch_dictionary())
    # a criterion that stays unported names its ROADMAP item; adaptive_loss is ported
    with pytest.raises(NotImplementedError, match=r"ROADMAP Queue A item 9\)"):
        task.build_criterion(argparse.Namespace(**{**vars(args), "criterion": "nat_loss"}))
    task.build_criterion(argparse.Namespace(**{**vars(args), "criterion": "adaptive_loss"}))
    model = tct.build_model("conv_transformer", torch_dictionary(), device="cpu", **SMALL)
    crit = task.build_criterion(args)
    for option in (dict(steps_per_execution=4), dict(quant_noise_scalar=0.1)):
        with pytest.raises(NotImplementedError):
            Trainer(argparse.Namespace(**{**vars(args), **option}), task, model, crit)
    # the mesh's options need a process group
    with pytest.raises(ValueError, match="--distributed-world-size"):
        Trainer(argparse.Namespace(**{**vars(args), "model_parallel_size": 2}), task, model, crit)
    # every optimiser and scheduler of the JAX package is ported
    Trainer(argparse.Namespace(**{**vars(args), "optimizer": "sgd", "momentum": 0.0, "lr_scheduler": "fixed",
                                  "force_anneal": None, "lr_shrink": 0.1}), task, model, crit)
    # a model's frozen parameters stay out of the update
    model.frozen_param_filter = lambda name: name.startswith("encoder.")
    trainer = Trainer(args, task, model, crit)
    frozen = {id(p) for name, p in model.named_parameters() if name.startswith("encoder.")}
    assert frozen and not frozen & {id(p) for p in trainer.params}
    assert len(trainer.params) == sum(1 for _ in model.parameters()) - len(frozen)
