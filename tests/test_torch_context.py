"""PyTorch port, context-aware ST (INTERSPEECH 2020): the context layers and
``conv_transformer_context``, the weight bridge, the presets, the ctxreg
criterion against the JAX package on the same numpy inputs and weights, on
the CPU (the chained generators: tests/test_torch_context_generate.py).

The models are tests/test_context_model.py's SMALL config (2 + 2 layers,
widths 16-32, 2 heads, 8 mels, ``[(4, 3, 3)] * 2``), one context encoder
layer, with weights drawn in the shapes of the JAX init
(``jax.eval_shape``); the JAX forwards run under ``jax.jit``. Everything is
fp32 in eval mode. The tolerance is 1e-5 absolute unless a test says
otherwise."""

import argparse
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fbk_fairseq_st_tpu.models.conv_transformer_context  # noqa: F401  (registers the JAX model)
from fbk_fairseq_st_tpu import registry
from fbk_fairseq_st_tpu.criterions import label_smoothed_cross_entropy_ctx_reg as jctxreg
from fbk_fairseq_st_tpu.utils.fairseq_interop import export_parameters
from fbk_fairseq_st_tpu_torch.criterions import CRITERIONS
from fbk_fairseq_st_tpu_torch.models import ARCHITECTURES
from fbk_fairseq_st_tpu_torch.models import conv_transformer_context as tcc
from fbk_fairseq_st_tpu_torch.utils.weights import state_dict_from_jax

from .test_context_model import SMALL
from .test_torch_model import torch_dictionary
from .test_torch_multilingual import random_variables
from .utils import DummyTask, dummy_dictionary, model_args

ARCH = "conv_transformer_context"
VOCAB = 24
ATOL = 1e-5


def _np(x):
    return np.asarray(x.detach()) if isinstance(x, torch.Tensor) else np.asarray(x)


def jax_model(**over):
    args = model_args(ARCH, **{**SMALL, **over})
    registry.apply_architecture(args)
    return registry.build_model(args, DummyTask(dummy_dictionary(VOCAB)))


@functools.lru_cache(maxsize=None)
def built(context_type="tgt", position="both", attention="sequential"):
    """(JAX model, its variables as numpy, the port's model with them, in
    eval mode)."""
    over = dict(context_type=context_type, context_position=position, context_decoder_attention_type=attention)
    jmodel = jax_model(**over)
    variables = random_variables(jmodel, 0)
    tmodel = tcc.build_model(ARCH, torch_dictionary(VOCAB), device="cpu", **SMALL, **over)
    tmodel.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jmodel, variables, tmodel.eval()


def context_batch(context_type, seed=0, b=3, t=29):
    """Unequal source lengths, a padded target tail, and a context of
    unequal lengths: target ids ending in eos, then pads, or fbank frames."""
    rng = np.random.RandomState(seed)
    tgt = rng.randint(4, VOCAB + 4, size=(b, 6)).astype(np.int64)
    tgt[1, -2:] = 1
    batch = {
        "src_tokens": rng.randn(b, t, SMALL["input_feat_per_channel"]).astype(np.float32),
        "src_lengths": np.array([t, t - 7, t - 12][:b], np.int64),
        "prev_output_tokens": np.concatenate([np.full((b, 1), 2, np.int64), tgt[:, :-1]], axis=1),
        "target": tgt,
    }
    if context_type == "src":
        batch["context_tokens"] = rng.randn(b, 21, SMALL["input_feat_per_channel"]).astype(np.float32)
        batch["context_lengths"] = np.array([21, 13, 17][:b], np.int64)
    else:
        lengths = np.array([5, 3, 4][:b], np.int64)
        ctx = rng.randint(4, VOCAB + 4, size=(b, 5)).astype(np.int64)
        for i, n in enumerate(lengths):
            ctx[i, n - 1], ctx[i, n:] = 2, 1
        batch["context_tokens"], batch["context_lengths"] = ctx, lengths
    return batch


def _torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def jax_forward(jmodel, variables, batch):
    (logits, extra), _ = jax.jit(lambda v, b: jmodel.forward(v, b, training=False))(variables, _jax(batch))
    return np.asarray(logits), [np.asarray(g) for g in extra["ctx_gates"]]


CASES = [(c, p, a) for c in ("tgt", "src") for p in ("both", "encoder", "decoder") for a in ("sequential", "parallel")]


@pytest.mark.parametrize("context_type,position,attention", CASES, ids=["-".join(c) for c in CASES])
def test_logits_and_gates_match_jax(context_type, position, attention):
    """Eval mode, the same weights: the logits and every ``ctx_gates`` entry
    (one a decoder layer in parallel mode with a decoder context, none
    otherwise) within 1e-5 of JAX's ``forward``."""
    jmodel, variables, tmodel = built(context_type, position, attention)
    batch = context_batch(context_type)
    jlogits, jgates = jax_forward(jmodel, variables, batch)
    with torch.no_grad():
        tlogits, extra = tmodel(_torch(batch))
    np.testing.assert_allclose(_np(tlogits), jlogits, rtol=0, atol=ATOL)
    want_gates = 2 if attention == "parallel" and position in ("both", "decoder") else 0
    assert len(extra["ctx_gates"]) == len(jgates) == want_gates
    for got, want in zip(extra["ctx_gates"], jgates):
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=ATOL)
    assert extra["encoder_out"].context_out is not None


@pytest.mark.parametrize("context_type", ["tgt", "src"])
def test_context_changes_output(context_type):
    """Another context gives other logits; no context at all runs the model
    context-unaware."""
    _, _, tmodel = built(context_type)
    batch = context_batch(context_type)
    other = dict(batch, context_tokens=context_batch(context_type, seed=5)["context_tokens"])
    with torch.no_grad():
        a = tmodel(_torch(batch))[0]
        b = tmodel(_torch(other))[0]
        c = tmodel(_torch({k: v for k, v in batch.items() if not k.startswith("context")}))[0]
    assert not torch.allclose(a, b) and not torch.allclose(a, c)


def test_unknown_attention_type_raises():
    """The decoder's gating mode is sequential or parallel: another raises
    at the first context attention, as JAX's does; a layer without context
    never reads it."""
    _, variables, _ = built("tgt", "both", "sequential")
    tmodel = tcc.build_model(ARCH, torch_dictionary(VOCAB), device="cpu", context_decoder_attention_type="gated",
                             **SMALL).eval()
    batch = _torch(context_batch("tgt"))
    with pytest.raises(RuntimeError, match="Invalid decoder context attention type gated"):
        tmodel(batch)
    with pytest.raises(RuntimeError, match="Invalid decoder context attention type gated"):
        jax_forward(jax_model(context_decoder_attention_type="gated"), variables, context_batch("tgt"))
    encoder_only = tcc.build_model(ARCH, torch_dictionary(VOCAB), device="cpu", context_position="encoder",
                                   context_decoder_attention_type="gated", **SMALL).eval()
    with torch.no_grad():
        encoder_only(batch)


@pytest.mark.parametrize("context_type,attention", [("tgt", "sequential"), ("tgt", "parallel"),
                                                    ("src", "parallel")])
def test_incremental_decoding_matches_the_full_forward(context_type, attention):
    """``init_cache`` (the context's K/V projected once under ``ctx`` in
    every decoder layer) and ``decode_step`` token by token give the full
    forward's logits at every position of a real token within 1e-5 (a pad
    input takes the step's position in a step, the pad's in the full
    forward), in both gating modes."""
    _, _, tmodel = built(context_type, "both", attention)
    batch = context_batch(context_type)
    prev = batch["prev_output_tokens"]
    with torch.no_grad():
        full, _ = tmodel(_torch(batch))
        enc = tmodel.encode(torch.as_tensor(batch["src_tokens"]), torch.as_tensor(batch["src_lengths"]),
                            context_tokens=torch.as_tensor(batch["context_tokens"]),
                            context_lengths=torch.as_tensor(batch["context_lengths"]))
        cache = tmodel.init_cache(prev.shape[0], prev.shape[1], enc)
        assert all("ctx" in layer for layer in cache)
        steps = [tmodel.decode_step(torch.as_tensor(prev[:, t:t + 1]), cache, t, enc) for t in range(prev.shape[1])]
    for t, logits in enumerate(steps):
        real = prev[:, t] != 1
        np.testing.assert_allclose(_np(logits)[real], _np(full[:, t])[real], rtol=0, atol=ATOL, err_msg=f"step {t}")


def _fork_names_of_export(name):
    """``export_parameters``'s name -> the fork's (ROADMAP Queue C): the
    context LayerNorm of each side and the audio encoder's statistics."""
    if ".context_ln." in name:
        name = name.replace(".context_ln.", ".context_attn_layer_norm." if name.startswith("decoder.")
                            else ".context_layer_norm.")
    return name.replace(".audio_encoder_state.", ".audio_encoder.")


@pytest.mark.parametrize("context_type", ["tgt", "src"])
def test_bridge_matches_export_parameters(context_type):
    """``state_dict_from_jax`` gives ``export_parameters``'s names and
    values but for the leaves JAX misnames (``context_ln.*``, and
    ``audio_encoder_state.*`` for the audio context encoder's BatchNorm
    statistics, which are that encoder's buffers in the port); the names
    are the fork's and the state dict loads strictly; the audio encoder's
    buffers are JAX's ``audio_encoder_state``."""
    _, variables, tmodel = built(context_type, "both", "parallel")
    ours = state_dict_from_jax(variables)
    exported = export_parameters(variables)
    want = {_fork_names_of_export(k): v for k, v in exported.items()}
    assert sorted(ours) == sorted(want) == sorted(tmodel.state_dict())
    for name, value in want.items():
        np.testing.assert_array_equal(ours[name].numpy(), np.asarray(value), err_msg=name)
    misnamed = sorted(k for k in exported if k not in ours)
    assert misnamed and all(".context_ln." in k or ".audio_encoder_state." in k for k in misnamed)
    for side, norm in (("encoder", "context_layer_norm"), ("decoder", "context_attn_layer_norm")):
        for i in range(2):
            for block in ("context_attn.q_proj", "context_attn.out_proj", "context_gating_wi", "context_gating_ws",
                          norm):
                assert f"{side}.layers.{i}.{block}.weight" in ours
    for part in ("self_attn.k_proj", "self_attn_layer_norm", "fc1", "fc2", "final_layer_norm"):
        assert f"context_encoder.layers.0.{part}.weight" in ours
    if context_type == "src":
        state = variables["params"]["context_encoder"]["audio_encoder_state"]["frontend"]["bns"]
        for i, bn in enumerate(tmodel.context_encoder.audio_encoder.bn):
            np.testing.assert_array_equal(_np(bn.running_mean), state[i]["mean"])
            np.testing.assert_array_equal(_np(bn.running_var), state[i]["var"])


@pytest.mark.parametrize("arch", sorted(tcc.ARCHITECTURES))
def test_arch_presets_match_jax(arch):
    """Each preset builds the JAX registry's encoder, decoder and context
    configs, field by field, with each option given or left to the
    preset; the head dim is 64."""
    for over in ({}, dict(context_type="src", context_encoder_layers=2, context_position="decoder",
                          context_decoder_attention_type="parallel", freeze_pretrained="all")):
        args = model_args(arch, **over)
        registry.apply_architecture(args)
        jmodel = registry.build_model(args, DummyTask(dummy_dictionary(VOCAB)))
        enc, dec, ctx, options = tcc.configs(arch, torch_dictionary(VOCAB), **over)
        assert ARCHITECTURES[arch] is tcc
        assert enc.frontend._asdict() == jmodel.encoder_cfg.frontend._asdict()
        assert {k: v for k, v in enc._asdict().items() if k != "frontend"} == {
            k: v for k, v in jmodel.encoder_cfg._asdict().items() if k != "frontend"}
        jd = jmodel.decoder_cfg._asdict()
        assert dec._asdict() == {k: jd[k] for k in dec._fields}
        assert ctx._asdict() == jmodel.ctx_cfg._asdict()
        assert options == {"freeze_pretrained": jmodel.freeze_pretrained, "pretrained_model": None}
        assert enc.embed_dim // enc.heads == dec.embed_dim // dec.heads == 64


@pytest.mark.parametrize("alpha", [0.0, 0.5])
def test_ctxreg_loss_and_gradients_match_jax(alpha):
    """``label_smoothed_cross_entropy_ctxreg`` (label smoothing 0.1) in
    parallel mode: the loss, nll_loss and every logging output within 1e-5
    (rtol 1e-6 for sums above 10) of JAX's, and the gradient of the loss in
    every parameter within 1e-5 of ``jax.grad``'s; the penalty is alpha
    times the sum of every gate, pads included, and sequential mode (no
    gates) adds none."""
    jmodel, variables, tmodel = built("tgt", "both", "parallel")
    crit_args = argparse.Namespace(label_smoothing=0.1, ctx_reg_alpha=alpha, sentence_avg=False)
    jc = jctxreg.LabelSmoothedCrossEntropyCtxRegCriterion(DummyTask(dummy_dictionary(VOCAB)), crit_args)
    tc = CRITERIONS["label_smoothed_cross_entropy_ctxreg"].build_criterion(crit_args,
                                                                           DummyTask(torch_dictionary(VOCAB)))
    batch = context_batch("tgt", seed=3)

    def loss_fn(params):
        loss, ss, log, _ = jc(jmodel, {"params": params, "state": variables["state"]}, _jax(batch), training=False)
        return loss, (ss, log)

    (jloss, (jss, jlog)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    tmodel.zero_grad()
    tloss, tss, tlog = tc(tmodel, _torch(batch), training=False)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-6, atol=ATOL)
    assert int(tss) == int(jss)
    assert sorted(tlog) == sorted(jlog)
    for key, value in jlog.items():
        np.testing.assert_allclose(float(tlog[key]), float(value), rtol=1e-6, atol=ATOL, err_msg=key)
    want = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    got = {name: p.grad for name, p in tmodel.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, grad in want.items():
        g = np.zeros(grad.shape, np.float32) if got[name] is None else _np(got[name])
        np.testing.assert_allclose(g, grad.numpy(), rtol=0, atol=ATOL, err_msg=name)
    with torch.no_grad():
        logits, extra = tmodel(_torch(batch))
        penalty = sum(float(g.sum()) for g in extra["ctx_gates"])
        base = tc.compute_loss(tmodel, (logits, {"ctx_gates": []}), _torch(batch))[0]
    assert penalty > 0
    np.testing.assert_allclose(float(tloss.detach()) - float(base), alpha * penalty, rtol=1e-5, atol=ATOL)
    _, _, seq_model = built("tgt", "both", "sequential")
    with torch.no_grad():
        loss_seq = tc(seq_model, _torch(batch))[0]
        plain = CRITERIONS["label_smoothed_cross_entropy"].build_criterion(
            crit_args, DummyTask(torch_dictionary(VOCAB)))(seq_model, _torch(batch))[0]
    assert float(loss_seq) == float(plain)
