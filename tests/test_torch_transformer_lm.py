"""PyTorch port, the transformer language model: the adaptive input and
softmax (free and tied, with and without the tied projections), the
character embedder, ``--output-dictionary-size``, ``adaptive_loss`` and its
gradients, incremental decoding, the weight bridge leaf by leaf, the
presets (the model-parallel names included) and three train steps of the
port's Trainer against the JAX package, on the CPU.

Tiny widths (2 layers, 16 wide, 2 heads, 60 symbols, cutoffs 10,30);
JAX's weights are drawn in the shapes of ``jax.eval_shape(model.init)``
and its forwards jitted. fp32 with JAX's matmuls pinned to fp32."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbk_fairseq_st_tpu import options, registry
from fbk_fairseq_st_tpu.criterions.adaptive_loss import AdaptiveLoss as JaxAdaptiveLoss
from fbk_fairseq_st_tpu.data.dictionary import TruncatedDictionary as JaxTruncatedDictionary
import fbk_fairseq_st_tpu.models.model_parallel  # noqa: F401  (registers the JAX presets)
from fbk_fairseq_st_tpu.ops import adaptive_softmax as jas
from fbk_fairseq_st_tpu.ops import character_embedder as jce
from fbk_fairseq_st_tpu.tasks.language_modeling import LanguageModelingTask as JaxLanguageModelingTask
from fbk_fairseq_st_tpu.train.trainer import Trainer as JaxTrainer
from fbk_fairseq_st_tpu.utils.fairseq_interop import export_parameters, translate_path
from fbk_fairseq_st_tpu_torch import models as tmodels
from fbk_fairseq_st_tpu_torch.criterions import AdaptiveLoss
from fbk_fairseq_st_tpu_torch.data.dictionary import TruncatedDictionary
from fbk_fairseq_st_tpu_torch.models import transformer_lm as tlm
from fbk_fairseq_st_tpu_torch.ops import adaptive_softmax as tas
from fbk_fairseq_st_tpu_torch.ops import character_embedder as tce
from fbk_fairseq_st_tpu_torch.tasks import LanguageModelingTask
from fbk_fairseq_st_tpu_torch.train import Trainer
from fbk_fairseq_st_tpu_torch.utils.weights import fork_name, state_dict_from_jax

from .test_torch_model import random_variables, torch_dictionary
from .utils import dummy_dictionary, model_args

VOCAB = 60
PAD, EOS, UNK = 1, 2, 3
TINY = dict(decoder_layers=2, decoder_embed_dim=16, decoder_ffn_embed_dim=32, decoder_attention_heads=2,
            tokens_per_sample=32)
CUT = dict(adaptive_input_cutoff="10,30", adaptive_softmax_cutoff="10,30")
CHAR = dict(character_embeddings=True, character_filters="[(1, 4), (2, 8)]", character_embedding_dim=4,
            char_embedder_highway_layers=2)
# variant -> (arch, options, output dictionary size or None)
VARIANTS = {
    "plain": ("transformer_lm", {}, None),
    "gpt_tied_io_no_final_norm": ("transformer_lm_gpt", dict(share_decoder_input_output_embed=True,
                                                             no_decoder_final_norm=True), None),
    "adaptive_untied": ("transformer_lm", dict(adaptive_input=True, **CUT), None),
    "wiki103_tied_proj": ("transformer_lm_wiki103", CUT, None),
    "wiki103_tied_no_proj": ("transformer_lm_wiki103", dict(tie_adaptive_proj=False, **CUT), None),
    "gbw_char_embedder": ("transformer_lm_gbw", CHAR, None),
    "output_dictionary_size": ("transformer_lm", {}, 40),
}
ADAPTIVE = ("adaptive_untied", "wiki103_tied_proj", "wiki103_tied_no_proj")


class _Task:
    def __init__(self, src, tgt):
        self.source_dictionary = src
        self.target_dictionary = tgt


def _dicts(out_size):
    jd, td = dummy_dictionary(VOCAB - 4), torch_dictionary(VOCAB - 4)
    if out_size is None:
        return jd, jd, td, td
    return jd, JaxTruncatedDictionary(jd, out_size), td, TruncatedDictionary(td, out_size)


_PAIRS = {}


def _build_pair(variant):
    if variant not in _PAIRS:
        arch, over, out_size = VARIANTS[variant]
        jsrc, jtgt, tsrc, ttgt = _dicts(out_size)
        args = model_args(arch, **TINY, **over)
        registry.apply_architecture(args)
        jmodel = registry.build_model(args, _Task(jsrc, jtgt))
        variables = random_variables(jmodel, 0)
        tmodel = tlm.build_model(arch, ttgt, tsrc, device="cpu", seed=1, **TINY, **over)
        tmodel.load_state_dict(state_dict_from_jax(variables), strict=True)
        _PAIRS[variant] = (jmodel, variables, tmodel)
    return _PAIRS[variant]


def _tokens(seed=0, b=3, t=9):
    rng = np.random.RandomState(seed)
    src = rng.randint(4, VOCAB, size=(b, t))
    src[0, 3], src[1, 2] = EOS, UNK
    src[2, -2:] = PAD
    return src


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_outputs_match_jax(variant):
    """The forward's output (logits; fp32 log-probabilities under the
    adaptive softmax) at atol 1e-4 in eval mode, and under the adaptive
    softmax a distribution: logsumexp 0."""
    jmodel, variables, tmodel = _build_pair(variant)
    src = _tokens()
    jout = jax.jit(lambda v, s: jmodel.forward(v, {"src_tokens": s})[0][0])(variables, jnp.asarray(src))
    with torch.no_grad():
        tout, _ = tmodel({"src_tokens": torch.tensor(src)})
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0, atol=1e-4)
    if variant in ADAPTIVE:
        assert tout.dtype == torch.float32
        np.testing.assert_allclose(torch.logsumexp(tout, -1).numpy(), 0.0, atol=1e-5)
    if variant == "output_dictionary_size":
        assert tout.shape[-1] == 40 and tmodel.decoder.embed_tokens.weight.shape[0] == VOCAB


@pytest.mark.parametrize("variant", ["plain", "wiki103_tied_proj", "gbw_char_embedder"])
def test_incremental_decode_matches_jax_step_by_step(variant):
    """decode_step against JAX's at every step (atol 1e-4) and against the
    port's own teacher-forced output."""
    jmodel, variables, tmodel = _build_pair(variant)
    src = np.where(_tokens(seed=2) == PAD, 5, _tokens(seed=2))
    lengths = np.full(3, src.shape[1])
    jenc = jmodel.encode(variables, jnp.asarray(src), jnp.asarray(lengths))[0]
    jcache = jmodel.init_cache(variables, 3, src.shape[1], jenc)
    jstep = jax.jit(lambda v, t, c, i, e: jmodel.decode_step(v, t, c, i, e)[:2])
    with torch.no_grad():
        tenc = tmodel.encode(torch.tensor(src), torch.tensor(lengths))
        tcache = tmodel.init_cache(3, src.shape[1], tenc)
        full, _ = tmodel({"src_tokens": torch.tensor(src)})
        for i in range(src.shape[1]):
            jlog, jcache = jstep(variables, jnp.asarray(src[:, i:i + 1]), jcache, jnp.int32(i), jenc)
            tlog = tmodel.decode_step(torch.tensor(src[:, i:i + 1]), tcache, i, tenc)
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0, atol=1e-4, err_msg=f"step {i}")
            np.testing.assert_allclose(tlog.numpy(), full[:, i].numpy(), rtol=0, atol=1e-4)


def _lm_batch(seed=3):
    src = _tokens(seed)
    target = np.concatenate([src[:, 1:], np.full((3, 1), EOS)], axis=1)
    target[2, -3:] = PAD
    return src, target


@pytest.mark.parametrize("variant", ADAPTIVE)
def test_adaptive_loss_and_gradients_match_jax(variant):
    """adaptive_loss's summed NLL (atol 1e-4), its logging outputs, the
    base-2 metrics of ``reduce_metrics`` (sentence and token averages), and
    the gradient of every parameter against ``jax.grad`` through the
    bridge's names (atol 1e-4): a tied table's gradient sums both of its
    uses, as JAX's single leaf does."""
    jmodel, variables, tmodel = _build_pair(variant)
    jd = dummy_dictionary(VOCAB - 4)
    src, target = _lm_batch()
    jcrit = JaxAdaptiveLoss(_Task(jd, jd), argparse.Namespace(sentence_avg=False))
    jbatch = {"src_tokens": jnp.asarray(src), "target": jnp.asarray(target)}

    def loss_fn(params):
        loss, _, log, _ = jcrit(jmodel, {"params": params, "state": {}}, jbatch, training=False)
        return loss, log

    (jloss, jlog), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    tcrit = AdaptiveLoss(_Task(torch_dictionary(VOCAB - 4), torch_dictionary(VOCAB - 4)),
                         argparse.Namespace(sentence_avg=False))
    tmodel.zero_grad()
    loss, sample_size, log = tcrit(tmodel, {"src_tokens": torch.tensor(src), "target": torch.tensor(target)})
    loss.backward()
    tmodel.eval()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=0, atol=1e-4)
    assert int(sample_size) == int(jlog["ntokens"]) == int((target != PAD).sum())
    want_grads = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(), rtol=0, atol=1e-4, err_msg=name)
    for sentence_avg in (False, True):
        logs = [{k: float(v) for k, v in log.items()}] * 2
        if sentence_avg:
            logs = [{**lo, "sample_size": lo["nsentences"]} for lo in logs]
        want = {}

        class _Metrics:
            @staticmethod
            def log_scalar(key, value, weight, round=None):
                want[key] = value

            @staticmethod
            def log_derived(key, fn):
                pass

        JaxAdaptiveLoss.reduce_metrics(logs, _Metrics)
        got = AdaptiveLoss.reduce_metrics(logs)
        assert set(want) <= set(got)
        for key, value in want.items():
            np.testing.assert_allclose(got[key], value, rtol=1e-12, err_msg=key)


def test_adaptive_ops_match_jax():
    """The ops alone: ``_parse_cutoff``, the adaptive input at clamped ids
    (pad row 0), the free and tied log-probs, against JAX's functions
    (atol 1e-5); the tied form raises NotImplementedError when band 0's
    dim is not the decoder's, as JAX's does."""
    for cutoff, vocab in (("10,30", 60), ([10, 30, 80], 60), ((5,), 5)):
        assert tas._parse_cutoff(cutoff, vocab) == jas._parse_cutoff(cutoff, vocab)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 16).astype(np.float32)
    ids = rng.randint(0, 60, size=(2, 5))
    ids[0, 0] = PAD
    for tie_proj in (True, False):
        inp = tas.AdaptiveInput(60, PAD, 16, 4.0, 16, (10, 30))
        inp.init(torch.Generator().manual_seed(0))
        soft = tas.AdaptiveSoftmax(60, 16, (10, 30), 4.0, tied_to=inp, tie_proj=tie_proj)
        soft.init(torch.Generator().manual_seed(1))
        sd = {k: v.detach().numpy() for k, v in {**inp.state_dict(), **{
            f"s.{k}": v for k, v in soft.state_dict().items()}}.items()}
        jinp = {"clusters": [{"embed": {"w": sd[f"embeddings.{i}.0.weight"]},
                              "proj": {"w": sd[f"embeddings.{i}.1.weight"].T}} for i in range(3)]}
        jsoft = {"class_proj": {"w": sd["s.head.class_proj.weight"].T}}
        if not tie_proj:
            jsoft["projs"] = [{"w": sd[f"s.tail.{i}.0.weight"].T} for i in range(2)]
        assert not inp.embeddings[0][0].weight[PAD].any()
        with torch.no_grad():
            np.testing.assert_allclose(inp(torch.tensor(ids)).numpy(), np.asarray(jas.adaptive_embed(
                jinp, (10, 30, 60), jnp.asarray(ids))), rtol=0, atol=1e-5)
            np.testing.assert_allclose(soft.log_probs(torch.tensor(x)).numpy(), np.asarray(
                jas.tied_adaptive_log_probs(jsoft, jinp, (10, 30, 60), jnp.asarray(x), tie_proj)), rtol=0, atol=1e-5)
    free = tas.AdaptiveSoftmax(60, 16, (10, 30), 4.0)
    free.init(torch.Generator().manual_seed(2))
    jfree = {"head": {"w": free.head.weight.detach().numpy().T},
             "tails": [{"proj": {"w": t[0].weight.detach().numpy().T}, "out": {"w": t[2].weight.detach().numpy().T}}
                       for t in free.tail]}
    with torch.no_grad():
        np.testing.assert_allclose(free.log_probs(torch.tensor(x)).numpy(), np.asarray(
            jas.adaptive_log_probs(jfree, (10, 30, 60), jnp.asarray(x))), rtol=0, atol=1e-5)
    narrow = tas.AdaptiveInput(60, PAD, 8, 4.0, 16, (10, 30))
    with pytest.raises(NotImplementedError):
        tas.AdaptiveSoftmax(60, 16, (10, 30), 4.0, tied_to=narrow)
    jnarrow = {"clusters": [{"embed": {"w": np.zeros((10, 8), np.float32)}}]}
    with pytest.raises(NotImplementedError):
        jas.tied_adaptive_log_probs({}, jnarrow, (10, 60), jnp.asarray(x), True)


def test_character_embedder_matches_jax():
    """build_word_to_char's table, and the char-CNN + highway embedder
    (pad 0, eos and unk their symbol rows) against JAX's at atol 1e-5."""
    jd, td = dummy_dictionary(VOCAB - 4), torch_dictionary(VOCAB - 4)
    np.testing.assert_array_equal(tce.build_word_to_char(td, 12), jce.build_word_to_char(jd, 12))
    cfg = tce.CharEmbedderConfig(filters=((1, 4), (2, 8), (3, 6)), char_embed_dim=4, word_embed_dim=16,
                                 highway_layers=2, max_char_len=12)
    jcfg = jce.CharEmbedderConfig(*cfg)
    table = tce.build_word_to_char(td, 12)
    emb = tce.CharacterTokenEmbedder(cfg, table, PAD, EOS, UNK)
    emb.init(torch.Generator().manual_seed(0))
    assert not emb.char_embeddings.weight[0].any()
    assert (emb.highway.layers[0].bias[18:] == 1).all()
    p = {k: v.detach().numpy() for k, v in emb.state_dict().items()}
    jp = {"char_embeddings": p["char_embeddings.weight"], "symbol_embeddings": p["symbol_embeddings"],
          "convs": [{"w": p[f"convolutions.{i}.weight"].transpose(2, 1, 0), "b": p[f"convolutions.{i}.bias"]}
                    for i in range(3)],
          "highway": [{"w": p[f"highway.layers.{i}.weight"].T, "b": p[f"highway.layers.{i}.bias"]} for i in range(2)],
          "projection": {"w": p["projection.weight"].T, "b": p["projection.bias"]}}
    ids = _tokens()
    want = jax.jit(lambda p_, i_: jce.character_embed(p_, jcfg, table, i_, PAD, EOS, UNK))(jp, jnp.asarray(ids))
    with torch.no_grad():
        got = emb(torch.tensor(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert not got[2, -1].any()


def test_adaptive_input_tied_to_a_dense_projection_raises():
    """Adaptive input with --share-decoder-input-output-embed and no
    adaptive softmax: JAX raises ValueError at the output layer, the port
    when it builds the decoder; --tie-adaptive-weights without matching
    factors raises in both builds."""
    over = dict(adaptive_input=True, adaptive_input_cutoff="10,30", share_decoder_input_output_embed=True)
    jd, td = dummy_dictionary(VOCAB - 4), torch_dictionary(VOCAB - 4)
    args = model_args("transformer_lm", **TINY, **over)
    registry.apply_architecture(args)
    jmodel = registry.build_model(args, _Task(jd, jd))
    with pytest.raises(ValueError, match="dense output"):  # raised while tracing
        jax.jit(lambda v, s: jmodel.forward(v, {"src_tokens": s}))(random_variables(jmodel, 0),
                                                                   jnp.asarray(_tokens()))
    with pytest.raises(ValueError, match="dense output"):
        tlm.build_model("transformer_lm", td, td, device="cpu", **TINY, **over)
    mismatch = dict(adaptive_input_factor=2.0, **CUT)
    args = model_args("transformer_lm_wiki103", **TINY, **mismatch)
    registry.apply_architecture(args)
    with pytest.raises(ValueError, match="factor"):
        registry.build_model(args, _Task(jd, jd))
    with pytest.raises(ValueError, match="factor"):
        tlm.build_model("transformer_lm_wiki103", td, td, device="cpu", **TINY, **mismatch)


def _expected_layout(path, leaf):
    """A JAX leaf in the fork's layout, written out by kind: tables as they
    are, linear weights transposed, the char embedder's (W, C_in, C_out)
    kernels as Conv1d's (C_out, C_in, W)."""
    leaf = np.asarray(leaf)
    if path[-1] != "w" or leaf.ndim == 1:
        return leaf
    if "embed" in path or path[-2] == "embed_tokens":
        return leaf
    if leaf.ndim == 3:
        return leaf.transpose(2, 1, 0)
    return leaf.T


@pytest.mark.parametrize("variant", ["wiki103_tied_proj", "wiki103_tied_no_proj", "adaptive_untied",
                                     "gbw_char_embedder"])
def test_state_dict_from_jax_leaf_by_leaf(variant):
    """Each JAX leaf lands under its fork name in the fork's layout, and
    the tied tables again under the adaptive softmax's names (one tensor).
    Against export_parameters: the names differ where JAX flattens its tree
    by path (``adaptive_input.clusters.{i}.embed``, ``adaptive_softmax.tails``,
    ``char_embedder.convs``: ROADMAP Queue C, JAX side), and the values
    agree but for the band tables, which the export transposes."""
    jmodel, variables, tmodel = _build_pair(variant)
    ours = state_dict_from_jax(variables)
    assert sorted(ours) == sorted(tmodel.state_dict())
    theirs = export_parameters(variables)
    renamed = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(variables["params"]):
        parts = [str(getattr(p, "key", getattr(p, "idx", p))) for p in path]
        name = fork_name(parts)
        np.testing.assert_array_equal(ours[name].numpy(), _expected_layout(parts, leaf), err_msg=name)
        export_name = translate_path(parts).replace("embed_out", "output_projection.weight")
        exported = theirs[export_name]
        if export_name != name:
            renamed += 1
        if exported.shape != ours[name].shape:  # a band table, transposed by the export
            exported = exported.T if exported.ndim == 2 else exported.transpose(2, 1, 0)
        np.testing.assert_array_equal(ours[name].numpy(), exported, err_msg=name)
    assert renamed > 0
    dec = tmodel.decoder
    if variant.startswith("wiki103"):
        assert dec.adaptive_softmax.head.word_proj.weight is dec.embed_tokens.embeddings[0][0].weight
        assert (dec.adaptive_softmax.tail[1][0].weight is dec.embed_tokens.embeddings[2][1].weight) == (
            variant == "wiki103_tied_proj")
        assert len(ours) > len(list(tmodel.named_parameters()))


@pytest.mark.parametrize("arch", sorted(tlm.ARCHITECTURES))
def test_arch_presets_match_jax(arch):
    """Each of the 10 preset names of models/transformer_lm.py and the 3
    model-parallel LM names builds JAX's decoder config field by field (the
    8.3 B / 11 B megatron widths included: configs only, no weights)."""
    jd, td = dummy_dictionary(VOCAB - 4), torch_dictionary(VOCAB - 4)
    over = CUT if arch.endswith("wiki103") else {}
    args = model_args(arch, **over)
    registry.apply_architecture(args)
    jmodel = registry.build_model(args, _Task(jd, jd))
    cfg, _ = tlm.configs(arch, td, td, **over)
    assert cfg._asdict() == jmodel.cfg._asdict()
    assert tmodels.ARCHITECTURES[arch] is tlm


TRAIN_ARGV = [
    "/nonexistent", "--task", "language_modeling", "--arch", "transformer_lm_wiki103", "--criterion",
    "adaptive_loss", "--optimizer", "adam", "--adam-betas", "(0.9, 0.98)", "--weight-decay", "0.0001", "--lr",
    "0.002", "--lr-scheduler", "inverse_sqrt", "--warmup-updates", "2", "--clip-norm", "10.0",
    "--dropout", "0", "--attention-dropout", "0", "--relu-dropout", "0", "--distributed-world-size", "1",
    "--adaptive-input-cutoff", "10,30", "--adaptive-softmax-cutoff", "10,30",
] + [f"--{k.replace('_', '-')}={v}" for k, v in TINY.items()]


class _DeterministicJaxAdaptiveLoss(JaxAdaptiveLoss):
    def __call__(self, model, variables, batch, rng=None, training=False):
        return super().__call__(model, variables, batch, rng=rng, training=False)


class _DeterministicAdaptiveLoss(AdaptiveLoss):
    def __call__(self, model, batch, generator=None, training=False):
        return super().__call__(model, batch, generator, training=False)


def _lm_sample(seed):
    src, target = _lm_batch(seed)
    return {"id": np.arange(3), "net_input": {"src_tokens": src, "src_lengths": np.array([9, 9, 7])},
            "target": target, "ntokens": int((target != PAD).sum()), "nsentences": 3}


_JAX_RUN = {}


def _jax_run():
    """JAX's three updates, made once for the file (its start weights, each
    update's logging outputs and gnorm, the summed lr, its final weights):
    JAX's --bf16 leaves a text model in fp32 (ROADMAP Queue C), so the one
    run is the reference of the port's fp32 and bf16 steps alike."""
    if not _JAX_RUN:
        args = options.parse_args_and_arch(options.get_training_parser(), TRAIN_ARGV)
        jd = dummy_dictionary(VOCAB - 4)
        jtask = JaxLanguageModelingTask(args, jd)
        jtrainer = JaxTrainer(args, jtask, jtask.build_model(args), _DeterministicJaxAdaptiveLoss(jtask, args))
        gnorms = []
        log_training = jtrainer._log_training
        jtrainer._log_training = lambda lo, gnorm, meta: (gnorms.append(gnorm), log_training(lo, gnorm, meta))
        start = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jtrainer.variables()))
        logs, lr_sum = [], 0.0
        for step in range(3):
            lr_sum += jtrainer.lr_scheduler.step_update(step)
            logs.append(jtrainer.train_step([_lm_sample(10 + step)]))
        _JAX_RUN.update(start=start, logs=logs, gnorms=gnorms, lr_sum=lr_sum,
                        after=state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jtrainer.variables())))
    return _JAX_RUN


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_train_steps_match_jax_trainer(dtype):
    """Three train steps of the port's Trainer on the language-modeling
    task against JAX's (the tiny tied wiki103 LM, adaptive_loss in eval
    mode, warmup 2, weight decay on). fp32: loss and gnorm rtol 1e-5, every
    weight atol 1e-5. bf16 (the port computes the model in bf16 and its
    log-probabilities in fp32; JAX's --bf16 leaves a text model in fp32):
    loss rtol 2e-3, gnorm 2e-2, weights within 2 x the summed lr. The
    key-projection biases, whose exact gradient is 0, are held to 2 x the
    summed lr in both (tests/test_torch_train.py). The tied tables stay one
    tensor."""
    want = _jax_run()
    args = options.parse_args_and_arch(options.get_training_parser(),
                                       TRAIN_ARGV + (["--bf16"] if dtype == "bf16" else []))
    td = torch_dictionary(VOCAB - 4)
    ttask = LanguageModelingTask(args, td)
    tmodel = ttask.build_model(args, device="cpu")
    tmodel.load_state_dict(want["start"], strict=True)
    ttrainer = Trainer(args, ttask, tmodel, _DeterministicAdaptiveLoss(ttask, args))
    rtol, grtol = (1e-5, 1e-5) if dtype == "fp32" else (2e-3, 2e-2)
    for step in range(3):
        got = ttrainer.train_step([_lm_sample(10 + step)])
        np.testing.assert_allclose(float(got["loss"]), want["logs"][step]["loss"], rtol=rtol,
                                   err_msg=f"loss step {step}")
        np.testing.assert_allclose(float(got["gnorm"]), want["gnorms"][step], rtol=grtol,
                                   err_msg=f"gnorm step {step}")
    got_sd = ttrainer.model.state_dict()
    assert sorted(got_sd) == sorted(want["after"])
    for name, value in want["after"].items():
        atol = 2 * want["lr_sum"] if (dtype == "bf16" or name.endswith("k_proj.bias")) else 1e-5
        np.testing.assert_allclose(got_sd[name].numpy(), value.numpy(), rtol=0, atol=atol, err_msg=name)
    dec = ttrainer.model.decoder
    assert dec.adaptive_softmax.tail[0][2].weight is dec.embed_tokens.embeddings[1][0].weight


TP_ARGV = ["/nonexistent", "--task", "language_modeling", "--arch", "model_parallel_transformer_lm", "--criterion",
           "cross_entropy", "--optimizer", "adam", "--adam-betas", "(0.9, 0.98)", "--weight-decay", "0.0001",
           "--lr", "0.002", "--lr-scheduler", "inverse_sqrt", "--warmup-updates", "2", "--clip-norm", "10.0",
           "--dropout", "0", "--attention-dropout", "0", "--relu-dropout", "0",
           ] + [f"--{k.replace('_', '-')}={v}" for k, v in TINY.items()]
TP_UPDATES = [[_lm_sample(20 + i)] for i in range(3)]


def _model_parallel_runs(directory):
    """JAX's unsharded Trainer on the global batches (dropout the identity)
    and the port's at TP 2 and TP 2 with sequence parallelism, in one spawn
    of two gloo ranks."""
    from fbk_fairseq_st_tpu.models import transformer_lm  # noqa: F401  (its dropout is patched)

    from . import test_torch_distributed
    from .test_torch_distributed import JaxRun, no_jax_dropout
    from .torch_dist import start_ranks

    with pytest.MonkeyPatch.context() as mp:
        no_jax_dropout(mp)
        mp.setattr(test_torch_distributed, "VOCAB", VOCAB - 4)  # JaxRun's dictionary: this file's
        jrun = JaxRun(TP_ARGV)
        wait = start_ranks(2, [(name, dict(fn="train", argv=TP_ARGV, vocab=VOCAB - 4, init_state=jrun.start,
                                           updates=TP_UPDATES, model=2, argv_extra=extra))
                               for name, extra in (("tp2", []), ("tp2_sp", ["--sequence-parallel"]))], directory)
        want = jrun.run(TP_UPDATES)
    return want, wait()


def test_model_parallel_transformer_lm_at_tp2_matches_jax(tmp_path):
    """``model_parallel_transformer_lm`` at ``--model-parallel-size 2`` over
    two gloo processes (the decoder's vocabulary, attention heads and FFN
    split; with and without sequence parallelism) takes JAX's unsharded
    steps: per update the loss, counts and gnorm at rtol 1e-5, then every
    weight gathered whole (tests/test_torch_distributed.py::assert_matches);
    each rank holds half the embedding."""
    from .test_torch_distributed import assert_matches

    want, ranks = _model_parallel_runs(str(tmp_path))
    for case in ("tp2", "tp2_sp"):
        out = [r for r in ranks[case] if r is not None]
        assert len(out) == 2 and out[0]["logs"] == out[1]["logs"]
        assert_matches(out[0]["logs"], out[0]["state"], want, keys=("loss", "ntokens", "nsentences", "sample_size"))
        assert out[1]["shapes"]["decoder.embed_tokens.weight"][0] == VOCAB // 2
