"""PyTorch port, quantisation: quant-noise (--quant-noise-pq) and its use in
the transformer layers, scalar int8 emulation and --quant-noise-scalar,
weight-only int8 (--quantize-weights int8), iPQ and the staged
--quantization-config-path run, against the JAX package on the same numpy
inputs, on the CPU.

JAX's linears are (in, out), the port's (out, in): every comparison
transposes through the weight bridge (``state_dict_from_jax``). Where JAX
draws a mask from its PRNG, the test draws one mask and hands it to both
sides. Tiny models (2 + 2 layers, 16 or 32 wide); JAX's weights are drawn
in the shapes of ``jax.eval_shape(model.init)`` and its forwards jitted.
Tolerances are stated per test."""

import argparse
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbk_fairseq_st_tpu import registry
from fbk_fairseq_st_tpu.ops import core as jcore
from fbk_fairseq_st_tpu.ops import transformer_layer as jtl
from fbk_fairseq_st_tpu.ops.core import RngStream
from fbk_fairseq_st_tpu.quantization import pq as jpq
from fbk_fairseq_st_tpu.quantization import quantizer as jquantizer
from fbk_fairseq_st_tpu.quantization import scalar as jscalar
from fbk_fairseq_st_tpu.quantization import weight_only as jwo
from fbk_fairseq_st_tpu_torch import models as tmodels
from fbk_fairseq_st_tpu_torch import options as toptions
from fbk_fairseq_st_tpu_torch.cli import generate as t_generate_cli
from fbk_fairseq_st_tpu_torch.cli import train as t_train_cli
from fbk_fairseq_st_tpu_torch.ops import transformer_layer as ttl
from fbk_fairseq_st_tpu_torch.ops.core import make_generators
from fbk_fairseq_st_tpu_torch.quantization import pq as tpq
from fbk_fairseq_st_tpu_torch.quantization import quant_noise as tqn
from fbk_fairseq_st_tpu_torch.quantization import quantizer as tquantizer
from fbk_fairseq_st_tpu_torch.quantization import scalar as tscalar
from fbk_fairseq_st_tpu_torch.quantization import weight_only as two
from fbk_fairseq_st_tpu_torch.train import checkpoint as tcheckpoint
from fbk_fairseq_st_tpu_torch.utils.weights import state_dict_from_jax

from .test_quantization_config import CONFIG_YAML
from .test_torch_model import random_variables, torch_dictionary
from .test_translation import TRANSLATION_ARGS, create_translation_data
from .utils import dummy_dictionary, model_args

# the module (the JAX package re-exports its function ``quant_noise`` under the same name)
jqn = importlib.import_module("fbk_fairseq_st_tpu.quantization.quant_noise")

VOCAB = 40
TINY = dict(encoder_layers=2, decoder_layers=2, encoder_embed_dim=32, decoder_embed_dim=32,
            encoder_ffn_embed_dim=64, decoder_ffn_embed_dim=64, encoder_attention_heads=2,
            decoder_attention_heads=2, max_source_positions=64, max_target_positions=32)
SPEECH = {**TINY, "input_feat_per_channel": 16}


class _Task:
    def __init__(self, d):
        self.source_dictionary = d
        self.target_dictionary = d


def _pair(arch, **over):
    args = model_args(arch, **over)
    registry.apply_architecture(args)
    jmodel = registry.build_model(args, _Task(dummy_dictionary(VOCAB)))
    variables = random_variables(jmodel, 0)
    td = torch_dictionary(VOCAB)
    tmodel = tmodels.build_model(arch, td, td, device="cpu", **over)
    tmodel.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jmodel, variables, tmodel


def _text_batch(seed=0, b=3, s=9, t=6):
    rng = np.random.RandomState(seed)
    src = np.full((b, s), 1, np.int64)
    lengths = np.array([s, s - 3, s - 5][:b], np.int64)
    for i, n in enumerate(lengths):
        src[i, s - n:] = rng.randint(4, VOCAB, size=n)
        src[i, -1] = 2
    prev = np.concatenate([np.full((b, 1), 2), rng.randint(4, VOCAB, size=(b, t - 1))], axis=1)
    return {"src_tokens": src, "src_lengths": lengths, "prev_output_tokens": prev}


# ---------------------------------------------------------------------------
# quant-noise
# ---------------------------------------------------------------------------

def test_quant_noise_drops_whole_blocks_and_matches_jax():
    """--quant-noise-pq on a linear: the identity at p 0; every (out unit,
    in block) either all 0 or all w / (1 - p); a weight whose in-features
    are off the block unchanged; and, given JAX's mask transposed, JAX's
    weight transposed within 1e-6. The last-axis ``quant_noise`` too, and
    its identity when deterministic."""
    rng = np.random.RandomState(0)
    w = rng.randn(24, 16).astype(np.float32)  # JAX (in, out)
    tw = torch.tensor(w.T.copy())  # the port's (out, in)
    p, block = 0.3, 4
    assert tqn.quant_noise_linear(tw, 0.0, block) is tw
    gen = torch.Generator().manual_seed(0)
    noised = tqn.quant_noise_linear(tw, p, block, gen)
    blocks = noised.reshape(16, 24 // block, block)
    kept = (blocks != 0).all(-1)
    assert ((blocks == 0).all(-1) | kept).all() and 0 < kept.float().mean() < 1
    torch.testing.assert_close(blocks[kept], (tw.reshape(16, 6, block) / (1 - p))[kept], rtol=0, atol=0)
    assert tqn.quant_noise_linear(torch.ones(5, 10), p, block, gen).equal(torch.ones(5, 10))
    key = jax.random.PRNGKey(3)
    want = np.asarray(jqn.quant_noise_linear(key, jnp.asarray(w), p, block))
    drop = np.asarray(jax.random.bernoulli(key, p, (24 // block, 16)))
    got = tqn.quant_noise_linear(tw, p, block, drop=torch.tensor(drop.T.copy()))
    np.testing.assert_allclose(got.numpy(), want.T, rtol=0, atol=1e-6)
    want = np.asarray(jqn.quant_noise(key, jnp.asarray(w), p, 4))
    drop = np.asarray(jax.random.bernoulli(key, p, (24, 4)))
    np.testing.assert_allclose(tqn.quant_noise(torch.tensor(w), p, 4, drop=torch.tensor(drop)).numpy(), want,
                               rtol=0, atol=1e-6)
    assert tqn.quant_noise(tw, p, 4, deterministic=True) is tw


@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_layer_quant_noise_matches_jax(kind, monkeypatch):
    """A transformer layer in training with --quant-noise-pq 0.25 (dropout
    rates 0) runs on JAX's noised weights: JAX's and the port's layer, each
    fed the same masks in ``_pq_noised``'s order (fc1, fc2, then each
    attention's q, k, v, out), agree within 1e-5; off training, none."""
    cfg = dict(embed_dim=16, ffn_dim=32, num_heads=2, dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
               normalize_before=False, quant_noise_pq=0.25, quant_noise_block=4)
    jcfg, tcfg = jtl.TransformerLayerConfig(**cfg), ttl.TransformerLayerConfig(**cfg)
    rng = np.random.RandomState(1)
    if kind == "encoder":
        jparams = jax.tree_util.tree_map(lambda a: (0.3 * rng.randn(*a.shape)).astype(np.float32),
                                         jax.eval_shape(lambda k: jtl.init_encoder_layer(k, jcfg),
                                                        jax.random.PRNGKey(0)))
        tlayer = ttl.TransformerEncoderLayer(tcfg)
        n_proj = 6
    else:
        jparams = jax.tree_util.tree_map(lambda a: (0.3 * rng.randn(*a.shape)).astype(np.float32),
                                         jax.eval_shape(lambda k: jtl.init_decoder_layer(k, jcfg),
                                                        jax.random.PRNGKey(0)))
        tlayer = ttl.TransformerDecoderLayer(tcfg)
        n_proj = 10
    sd = state_dict_from_jax({"params": {"layers": [jparams]}})
    tlayer.load_state_dict({k[len("layers.0."):]: v for k, v in sd.items()}, strict=True)
    tlayer.train()
    masks = [rng.rand(16 // 4 if i != 1 else 32 // 4, 32 if i == 0 else 16) < 0.25 for i in range(n_proj)]

    def jax_noise(key, w, p, block):  # JAX (in, out): a mask (in / block, out)
        drop = jnp.repeat(jnp.asarray(masks[jax_noise.i]), block, axis=0)
        jax_noise.i += 1
        return (jnp.where(drop, 0.0, w) / (1.0 - p)).astype(w.dtype)

    port_linear = tqn.quant_noise_linear

    def port_noise(w, p, block, generator=None, drop=None):  # the port's (out, in): the mask transposed
        drop = torch.tensor(masks[port_noise.i].T.copy())
        port_noise.i += 1
        return port_linear(w, p, block, drop=drop)

    jax_noise.i = port_noise.i = 0
    monkeypatch.setattr(jqn, "quant_noise_linear", jax_noise)
    monkeypatch.setattr(tqn, "quant_noise_linear", port_noise)
    x = rng.randn(2, 5, 16).astype(np.float32)
    mem = rng.randn(2, 7, 16).astype(np.float32)
    rngs = RngStream(jax.random.PRNGKey(0))
    gens = make_generators(0, "cpu")
    if kind == "encoder":
        want = jtl.encoder_layer(jparams, jcfg, jnp.asarray(x), rng=rngs, deterministic=False)
        got = tlayer(torch.tensor(x), generator=gens)
    else:
        want, _, _ = jtl.decoder_layer(jparams, jcfg, jnp.asarray(x), encoder_out=jnp.asarray(mem),
                                       self_attn_mask="causal", rng=rngs, deterministic=False)
        got = tlayer(torch.tensor(x), encoder_out=torch.tensor(mem), self_attn_mask="causal", generator=gens)
    assert jax_noise.i == port_noise.i == n_proj
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    got.sum().backward()
    assert tlayer.fc1.weight.grad is not None and float(tlayer.fc1.weight.grad.abs().sum()) > 0
    tlayer.eval()
    with torch.no_grad():
        tlayer(torch.tensor(x), generator=gens) if kind == "encoder" else tlayer(
            torch.tensor(x), encoder_out=torch.tensor(mem), generator=gens)
    assert port_noise.i == n_proj


# ---------------------------------------------------------------------------
# scalar
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["tensor", "channel", "histogram"])
def test_emulate_int_matches_jax(method):
    """``emulate_int`` per observer (``channel``: JAX's last axis of its
    (in, out) weight, axis 0 of the port's), on a linear weight and on a
    1-D leaf: the quantised values, scale and zero point equal JAX's, bit
    for bit. JAX's eager and jitted ``emulate_int`` differ in the last bit
    (XLA's fused kernels round its divisions and the percentile's
    interpolation otherwise); the port, one rounding an operation, equals
    the eager one, or where that differs from the jitted one (the
    histogram's interpolation) one of the two. The straight-through
    gradient is the identity."""
    rng = np.random.RandomState(2)
    w = (rng.randn(48, 20) * np.linspace(0.1, 3, 20)).astype(np.float32)
    jitted = jax.jit(lambda a: jscalar.emulate_int(a, 8, method))
    for arr, axis in ((w, 0), (rng.randn(300).astype(np.float32), -1)):
        eager = [np.asarray(x).reshape(-1) for x in jscalar.emulate_int(jnp.asarray(arr), 8, method)]
        jit = [np.asarray(x).reshape(-1) for x in jitted(jnp.asarray(arr))]
        port = torch.tensor(arr.T.copy() if arr.ndim == 2 else arr)
        got = [x.numpy() for x in tscalar.emulate_int(port, 8, method, channel_axis=axis)]
        got = [(got[0].T if arr.ndim == 2 else got[0]).reshape(-1)] + [x.reshape(-1) for x in got[1:]]
        eager_equal = all(np.array_equal(g, e) for g, e in zip(got, eager))
        jit_equal = all(np.array_equal(g, j) for g, j in zip(got, jit))
        assert eager_equal or (method == "histogram" and jit_equal), (method, arr.shape)
    x = torch.tensor(w, requires_grad=True)
    tscalar.fake_quantize(x, 8, method, channel_axis=0).sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))


def test_scalar_quant_noise_matches_jax_and_leaves_the_weights():
    """``scalar_quant_noise`` given JAX's keep mask equals JAX's; at p 1
    (every element takes its int8 value, JAX's mask all False) a model's
    loss and gradients under ``scalar_quant_noise_`` equal JAX's criterion
    on ``scalar_quant_noise_params`` (within 1e-5 and 1e-4 x the largest
    |grad|), the weights come back as they were, and ``Trainer.train_step``
    with --quant-noise-scalar and lr 0 leaves them bitwise."""
    rng = np.random.RandomState(3)
    w = rng.randn(32, 16).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jscalar.scalar_quant_noise(key, jnp.asarray(w), 0.4))
    keep = np.asarray(jax.random.bernoulli(key, 0.6, w.shape))
    got = tscalar.scalar_quant_noise(torch.tensor(w), 0.4, keep=torch.tensor(keep))
    np.testing.assert_array_equal(got.numpy(), want)

    from fbk_fairseq_st_tpu.criterions.label_smoothed_cross_entropy import LabelSmoothedCrossEntropyCriterion as JLS
    from fbk_fairseq_st_tpu_torch.criterions import LabelSmoothedCrossEntropyCriterion as TLS
    from fbk_fairseq_st_tpu_torch.train import Trainer

    jmodel, variables, tmodel = _pair("transformer", **TINY)
    batch = _text_batch()
    batch["target"] = np.concatenate([batch["prev_output_tokens"][:, 1:], np.full((3, 1), 2)], axis=1)
    args = argparse.Namespace(label_smoothing=0.1, sentence_avg=False)
    jcrit, tcrit = JLS(_Task(dummy_dictionary(VOCAB)), args), TLS(_Task(torch_dictionary(VOCAB)), args)

    def jloss(params):
        params = jscalar.scalar_quant_noise_params(params, key, 1.0)
        return jcrit(jmodel, {"params": params, "state": {}}, jb, training=False)[0]

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(variables["params"])
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    with tscalar.scalar_quant_noise_(tmodel, 1.0, make_generators(0, "cpu")):
        loss, _, _ = tcrit(tmodel, {k: torch.tensor(v) for k, v in batch.items()}, None, training=False)
        loss.backward()
    assert abs(loss.item() - float(want_loss)) <= 1e-5
    want = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, want_grads)})
    scale = max(float(g.abs().max()) for g in want.values())
    for name, p in tmodel.named_parameters():
        assert float((p.grad - want[name]).abs().max()) <= 1e-4 * scale, name
    assert all(torch.equal(v, tmodel.state_dict()[k]) for k, v in before.items())

    class _TT:
        target_dictionary = torch_dictionary(VOCAB)

        def augment_batch(self, b, g):
            return b

        def reduce_metrics(self, logs, criterion, metrics):
            criterion.reduce_metrics(logs, metrics)

    targs = argparse.Namespace(optimizer="adam", lr=[0.0], lr_scheduler="fixed", quant_noise_scalar=0.5, seed=1,
                               clip_norm=0.0, adam_betas="(0.9, 0.98)", adam_eps=1e-8, weight_decay=0.0,
                               label_smoothing=0.1)
    trainer = Trainer(targs, _TT(), tmodel, tcrit)
    trainer.train_step([{"net_input": {k: batch[k] for k in ("src_tokens", "src_lengths", "prev_output_tokens")},
                         "target": batch["target"], "ntokens": 18, "nsentences": 3, "id": np.arange(3)}])
    assert np.isfinite(trainer.flush_logs()["loss"])
    assert all(torch.equal(v, tmodel.state_dict()[k]) for k, v in before.items())


# ---------------------------------------------------------------------------
# weight-only int8
# ---------------------------------------------------------------------------

def test_int8_codes_and_scales_match_jax():
    """Per-channel int8: the codes bit for bit after the transpose, the
    scales within 1 ulp (here equal), a zero channel scaled 1; under bf16
    the dequantised weight is JAX's ``wq.astype(bf16) * scale.astype(bf16)``
    bitwise."""
    rng = np.random.RandomState(5)
    w = rng.randn(64, 48).astype(np.float32)  # JAX (in, out)
    w[:, 3] = 0.0
    j = jwo.quantize_weight(w)
    q, scale = two.quantize_weight(torch.tensor(w.T.copy()))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), j["w_q"].T)
    np.testing.assert_array_max_ulp(scale.numpy()[:, 0], j["w_scale"][0], maxulp=1)
    assert float(scale[3, 0]) == 1.0
    lin = two.Int8Linear(q, scale)
    want = np.asarray(jnp.asarray(j["w_q"]).astype(jnp.bfloat16) * jnp.asarray(j["w_scale"]).astype(jnp.bfloat16))
    np.testing.assert_array_equal(lin.weight_as(torch.bfloat16).float().numpy(), want.T.astype(np.float32))


@pytest.mark.parametrize("arch", ["transformer", "conv_transformer", "transformer_monotonic"])
def test_int8_layers_and_logits_match_jax(arch):
    """The same set of linears quantised as JAX's ``_is_linear_leaf``
    policy (min_size 512 at these widths; embeddings, convs and small
    projections excluded); JAX's quantised tree, through the bridge, loads
    strictly into the port's quantised model with equal codes and scales;
    the quantised logits within 1e-4 of JAX's."""
    over = SPEECH if arch == "conv_transformer" else TINY
    jmodel, variables, tmodel = _pair(arch, **over)
    qparams, jstats = jwo.quantize_linear_weights(variables["params"], min_size=512)
    stats = two.quantize_linear_weights(tmodel, min_size=512)
    jsd = state_dict_from_jax({"params": qparams, "state": variables.get("state") or {}})
    jnames = sorted(k[:-len(".weight_q")] for k in jsd if k.endswith(".weight_q"))
    assert sorted(stats["names"]) == jnames and stats["quantized"] == jstats["quantized"] > 0
    assert (stats["bytes_before"], stats["bytes_after"]) == (jstats["bytes_before"], jstats["bytes_after"])
    own = tmodel.state_dict()
    assert sorted(own) == sorted(jsd)
    for name in jnames:
        assert torch.equal(own[name + ".weight_q"], jsd[name + ".weight_q"]), name
        assert torch.equal(own[name + ".weight_scale"], jsd[name + ".weight_scale"]), name
    rng = np.random.RandomState(6)
    if arch == "conv_transformer":
        batch = {"src_tokens": rng.randn(2, 24, 16).astype(np.float32), "src_lengths": np.array([24, 17]),
                 "prev_output_tokens": np.concatenate([np.full((2, 1), 2), rng.randint(4, VOCAB, (2, 4))], 1)}
    else:
        batch = _text_batch()
    qvars = {**variables, "params": qparams}
    jlogits = jax.jit(lambda v, b: jmodel.forward(v, b)[0][0])(qvars, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        tlogits = tmodel({k: torch.tensor(v) for k, v in batch.items()})[0]
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# iPQ
# ---------------------------------------------------------------------------

def _differing(a, b):
    a, b = np.asarray(a).reshape(-1), np.asarray(b).reshape(-1)
    return [(int(i), int(a[i]), int(b[i])) for i in np.flatnonzero(a != b)]


def test_pq_matches_jax():
    """k-means iPQ on a (out, in) matrix: the assignments equal JAX's
    (every difference would be listed) and the centroids within 1e-5; the
    reconstruction is ``PQ.decode``; ``PQLinear``'s gradient reaches the
    centroids only."""
    rng = np.random.RandomState(7)
    w = rng.randn(24, 32).astype(np.float32)  # (out, in), as JAX's PQ takes it
    jp = jpq.PQ(w, block_size=4, n_centroids=16, n_iter=8)
    jp.encode()
    tp = tpq.PQ(torch.tensor(w), block_size=4, n_centroids=16, n_iter=8)
    tp.encode()
    diff = _differing(tp.assignments.numpy(), jp.assignments)
    assert not diff, f"assignments that differ (index, port, JAX): {diff}"
    np.testing.assert_allclose(tp.centroids.numpy(), jp.centroids, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tp.decode().numpy(), jp.decode(), rtol=0, atol=1e-5)
    lin = tpq.PQLinear(tp.centroids.clone(), tp.assignments.clone(), 24, 32)
    codes = jp.assignments.reshape(-1, 24).astype(np.float32)
    want = np.asarray(jcore.weight_of({"w_codes": jnp.asarray(codes), "w_centroids": jnp.asarray(jp.centroids)},
                                      jnp.float32))
    np.testing.assert_allclose(lin.weight.detach().numpy(), want.T, rtol=0, atol=1e-5)
    lin(torch.randn(3, 32)).sum().backward()
    assert float(lin.centroids.grad.abs().max()) > 0 and not lin.assignments.requires_grad


def test_quantize_layers_matches_jax_quantize_param_tree():
    """A stage of the default config on a tiny transformer: the same layers
    quantised as JAX's ``quantize_param_tree`` (fc1 / fc2 of the decoder,
    the attention projections through JAX's names), each layer's codes
    equal and centroids within 1e-5, and JAX's quantised tree loads
    strictly into the port's swapped model."""
    _, variables, tmodel = _pair("transformer", **TINY)
    config = tquantizer.parse_config_yaml({})
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    import re

    for regex in config["layers_to_quantize"][::2]:  # fc, then q / k / v / out
        jnames = jquantizer.quantize_param_tree(params, re.compile(regex), config["block_sizes"],
                                                config["n_centroids"])
        tnames = tquantizer.quantize_layers(tmodel, re.compile(regex), config["block_sizes"], config["n_centroids"])
        assert sorted(tquantizer.jax_name(n) for n in tnames) == sorted(jnames) and tnames
    jsd = state_dict_from_jax({"params": params})
    own = tmodel.state_dict()
    assert sorted(own) == sorted(jsd)
    for name in own:
        if name.endswith(".assignments"):
            diff = _differing(own[name], jsd[name])
            assert not diff, f"{name}: assignments that differ (index, port, JAX): {diff}"
        elif name.endswith(".centroids"):
            torch.testing.assert_close(own[name], jsd[name], rtol=0, atol=1e-5)


def test_quantization_options_parse_and_run(tmp_path):
    """--quantize-weights int8 and --quantization-config-path parse; the
    serving flags and the options NOT_PORTED lists no quantisation entry."""
    for name in ("quantize_weights", "quantization_config_path", "quant_noise_pq", "quant_noise_scalar"):
        assert name not in toptions.NOT_PORTED
    args = toptions.parse_args_and_arch(toptions.get_generation_parser(), ["data", "--quantize-weights", "int8"])
    assert args.quantize_weights == "int8"
    args = toptions.parse_args_and_arch(toptions.get_training_parser(), [
        "data", "--arch", "transformer", "--quantization-config-path", "q.yaml", "--quant-noise-pq", "0.1",
        "--quant-noise-scalar", "0.1"])
    assert (args.quantization_config_path, args.quant_noise_pq, args.quant_noise_scalar) == ("q.yaml", 0.1, 0.1)


def test_iterative_pq_training_e2e(tmp_path):
    """JAX's ``test_iterative_pq_training_e2e`` on the port: two iPQ stages
    over two epochs (fc1 / fc2, then self-attention through the fork's
    *_proj names), the encoder left; a resume from the quantised
    checkpoint keeps every code bitwise while the centroids train; then
    cli/generate decodes from it, and with --quantize-weights int8 on top."""
    data_dir, save_dir = str(tmp_path / "d"), str(tmp_path / "s")
    create_translation_data(data_dir, n=12)
    config = tmp_path / "q.yaml"
    config.write_text(CONFIG_YAML)
    args = [data_dir, "--save-dir", save_dir, "--quantization-config-path", str(config), "--cpu"] + TRANSLATION_ARGS
    assert args[args.index("--max-epoch") + 1] == "2"
    t_train_cli.cli_main(args)
    sd = tcheckpoint.load_checkpoint_to_cpu(os.path.join(save_dir, "checkpoint_last.pt"))["model"]
    for name in ("fc1", "fc2"):
        assert f"decoder.layers.0.{name}.assignments" in sd and f"decoder.layers.0.{name}.weight" not in sd
        assert tuple(sd[f"decoder.layers.0.{name}.centroids"].shape) == (4, 8)
    assert sd["decoder.layers.0.self_attn.q_proj.centroids"].shape[1] == 4
    assert "encoder.layers.0.fc1.weight" in sd
    codes = sd["decoder.layers.0.fc1.assignments"].clone()
    cents = sd["decoder.layers.0.fc1.centroids"].clone()
    args[args.index("--max-epoch") + 1] = "4"
    t_train_cli.cli_main(args)
    sd2 = tcheckpoint.load_checkpoint_to_cpu(os.path.join(save_dir, "checkpoint_last.pt"))["model"]
    assert torch.equal(sd2["decoder.layers.0.fc1.assignments"], codes)
    assert not torch.equal(sd2["decoder.layers.0.fc1.centroids"], cents), "centroids did not train"
    gen = [data_dir, "--task", "translation", "-s", "en", "-t", "de", "--path",
           os.path.join(save_dir, "checkpoint_last.pt"), "--gen-subset", "test", "--beam", "2", "--max-tokens", "200",
           "--log-format", "none", "--quiet", "--cpu"]
    assert t_generate_cli.cli_main(gen).stat.predlen > 0
    assert t_generate_cli.cli_main(gen + ["--quantize-weights", "int8"]).stat.predlen > 0
