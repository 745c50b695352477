"""PyTorch port, ``transformer_align`` and its criterion
(``label_smoothed_cross_entropy_with_alignment``), and the translation
task's ``--load-alignments`` and ``--truncate-source``, against the JAX
package on the same inputs, on the CPU.

Tiny widths (2 + 2 layers, 16 wide, 2 heads, the alignment layer 1);
JAX's weights are drawn in the shapes of ``jax.eval_shape(model.init)``.
The corpus is written by the port's ``cli/preprocess`` with
``--align-suffix`` (byte for byte JAX's, tests/test_torch_preprocess.py)."""

import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbk_fairseq_st_tpu import registry
from fbk_fairseq_st_tpu.criterions.label_smoothed_cross_entropy_with_alignment import (
    LabelSmoothedCrossEntropyCriterionWithAlignment as JaxAlignCriterion)
from fbk_fairseq_st_tpu.data.dictionary import Dictionary as JaxDictionary
import fbk_fairseq_st_tpu.models.transformer_align  # noqa: F401  (registers the JAX model)
from fbk_fairseq_st_tpu.tasks.translation import TranslationTask as JaxTranslationTask
from fbk_fairseq_st_tpu.utils.fairseq_interop import export_parameters
from fbk_fairseq_st_tpu_torch import models as tmodels
from fbk_fairseq_st_tpu_torch.cli import preprocess as tpreprocess
from fbk_fairseq_st_tpu_torch.criterions import CRITERIONS, LabelSmoothedCrossEntropyCriterionWithAlignment
from fbk_fairseq_st_tpu_torch.data.dictionary import Dictionary as TorchDictionary
from fbk_fairseq_st_tpu_torch.models import transformer_align as tal
from fbk_fairseq_st_tpu_torch.tasks import TranslationTask
from fbk_fairseq_st_tpu_torch.utils.weights import state_dict_from_jax

from .test_torch_model import SHARED_ROOT, random_variables, shared_root, torch_dictionary  # noqa: F401
from .torch_shared import shared
from .utils import dummy_dictionary, model_args

VOCAB = 24
PAD, EOS = 1, 2
TINY = dict(encoder_layers=2, decoder_layers=2, encoder_embed_dim=16, decoder_embed_dim=16,
            encoder_ffn_embed_dim=32, decoder_ffn_embed_dim=32, encoder_attention_heads=2,
            decoder_attention_heads=2, alignment_layer=1)


class _Task:
    def __init__(self, d):
        self.source_dictionary = d
        self.target_dictionary = d


_PAIRS = {}


def _build_pair(full_context):
    if full_context not in _PAIRS:
        over = dict(full_context_alignment=full_context)
        jd = dummy_dictionary(VOCAB)
        args = model_args("transformer_align", **TINY, **over)
        registry.apply_architecture(args)
        jmodel = registry.build_model(args, _Task(jd))
        variables = random_variables(jmodel, 0)
        td = torch_dictionary(VOCAB)
        tmodel = tal.build_model("transformer_align", td, td, device="cpu", **TINY, **over)
        tmodel.load_state_dict(state_dict_from_jax(variables), strict=True)
        _PAIRS[full_context] = (jd, jmodel, variables, td, tmodel)
    return _PAIRS[full_context]


def _batch(seed=0, b=3, s=9, t=6):
    rng = np.random.RandomState(seed)
    lengths = np.array([s, s - 3, s - 5])
    src = np.full((b, s), PAD, np.int64)
    for i, n in enumerate(lengths):
        src[i, s - n:] = rng.randint(4, VOCAB, size=n)
        src[i, -1] = EOS
    prev = np.concatenate([np.full((b, 1), EOS), rng.randint(4, VOCAB, size=(b, t - 1))], axis=1)
    prev[-1, -2:] = PAD
    target = np.concatenate([prev[:, 1:], np.full((b, 1), PAD)], axis=1)
    target[:-1, -1] = EOS
    target[-1, -3] = EOS
    weights = np.zeros((b, t, s), np.float32)
    for i in range(b):
        for j in range(t):
            if target[i, j] != PAD:
                links = rng.choice(np.arange(s - lengths[i], s), size=rng.randint(1, 3), replace=False)
                weights[i, j, links] = 1.0 / len(links)
    return {"src_tokens": src, "src_lengths": lengths, "prev_output_tokens": prev, "target": target,
            "align_weights": weights}


@pytest.mark.parametrize("full_context", [False, True])
def test_alignment_attention_matches_jax(full_context):
    """The logits and the alignment layer's head-averaged cross-attention
    ``extra["attn"]`` (the prefix of layers 0..alignment_layer, causal or
    full context) at atol 1e-4; each attention row sums to 1."""
    _, jmodel, variables, _, tmodel = _build_pair(full_context)
    batch = {k: v for k, v in _batch().items() if k not in ("target", "align_weights")}
    (jlogits, jextra), _ = jax.jit(lambda v, b: jmodel.forward(v, b))(
        variables, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        tlogits, textra = tmodel({k: torch.tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=0, atol=1e-4)
    np.testing.assert_allclose(textra["attn"].numpy(), np.asarray(jextra["attn"]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(textra["attn"].sum(-1).numpy(), 1.0, atol=1e-5)


def test_alignment_criterion_and_gradients_match_jax():
    """The criterion's loss (label-smoothed CE + 0.05 x the alignment
    loss), nll_loss and alignment_loss at atol 1e-4, every parameter's
    gradient against ``jax.grad`` at atol 1e-4, and ``reduce_metrics``'s
    values, in eval mode on both sides (the alignment pass runs without
    dropout whatever the model's mode)."""
    jd, jmodel, variables, td, tmodel = _build_pair(False)
    batch = _batch(seed=1)
    crit_args = argparse.Namespace(label_smoothing=0.1, sentence_avg=False, alignment_lambda=0.05)
    jcrit = JaxAlignCriterion(_Task(jd), crit_args)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        loss, _, log, _ = jcrit(jmodel, {"params": params, "state": {}}, jbatch, training=False)
        return loss, log

    (jloss, jlog), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    tcrit = LabelSmoothedCrossEntropyCriterionWithAlignment(_Task(td), crit_args)
    tmodel.zero_grad()
    loss, _, log = tcrit(tmodel, {k: torch.tensor(v) for k, v in batch.items()})
    loss.backward()
    tmodel.eval()
    for key in ("loss", "nll_loss", "alignment_loss"):
        np.testing.assert_allclose(float(log[key]), float(jlog[key]), rtol=0, atol=1e-4, err_msg=key)
    assert float(log["alignment_loss"]) > 0
    want = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=0, atol=1e-4, err_msg=name)
    logs = [{k: float(v) for k, v in log.items()}] * 2
    jvals = {}

    class _Metrics:
        @staticmethod
        def log_scalar(key, value, weight, round=None):
            jvals[key] = value

        @staticmethod
        def log_derived(key, fn):
            pass

    JaxAlignCriterion.reduce_metrics(logs, _Metrics)
    got = LabelSmoothedCrossEntropyCriterionWithAlignment.reduce_metrics(logs)
    for key, value in jvals.items():
        np.testing.assert_allclose(got[key], value, rtol=1e-12, err_msg=key)
    assert CRITERIONS["label_smoothed_cross_entropy_with_alignment"] is LabelSmoothedCrossEntropyCriterionWithAlignment


@pytest.mark.parametrize("arch", sorted(tal.ARCHITECTURES))
def test_arch_presets_match_jax(arch):
    """Both presets build JAX's configs and alignment options; the bridge
    equals export_parameters on the align model (the same leaves as the
    transformer's)."""
    jd = dummy_dictionary(VOCAB)
    args = model_args(arch)
    registry.apply_architecture(args)
    jmodel = registry.build_model(args, _Task(jd))
    td = torch_dictionary(VOCAB)
    targs = tal.defaults(arch)
    assert (targs["alignment_heads"], targs["alignment_layer"], targs["full_context_alignment"]) == (
        jmodel.alignment_heads, jmodel.alignment_layer, jmodel.full_context_alignment)
    from fbk_fairseq_st_tpu_torch.models import transformer as ttr

    enc, dec, share = ttr.configs_from_args(ttr.namespace(arch, tal.ARCHITECTURES[arch], tal.defaults(arch), {}),
                                            td, td)
    assert (enc._asdict(), dec._asdict(), share) == (jmodel.encoder_cfg._asdict(), jmodel.decoder_cfg._asdict(),
                                                     jmodel.share_all_embeddings)
    assert tmodels.ARCHITECTURES[arch] is tal
    _, _, variables, _, tmodel = _build_pair(False)
    ours, theirs = state_dict_from_jax(variables), export_parameters(variables)
    assert sorted(ours) == sorted(theirs) == sorted(tmodel.state_dict())


def _write_mt_corpus(root):
    rng = np.random.RandomState(0)
    raw = os.path.join(root, "raw")
    os.makedirs(raw)
    with open(os.path.join(raw, "dict.txt"), "w") as f:
        for i in range(4, VOCAB):
            f.write(f"w{i} 1\n")
    for split, n in (("train", 10), ("valid", 6)):
        with open(os.path.join(raw, f"{split}.en"), "w") as fs, open(os.path.join(raw, f"{split}.de"), "w") as ft, \
                open(os.path.join(raw, f"{split}.align"), "w") as fa:
            for _ in range(n):
                ls, lt = rng.randint(3, 12), rng.randint(2, 9)
                fs.write(" ".join(f"w{i}" for i in rng.randint(4, VOCAB, size=ls)) + "\n")
                ft.write(" ".join(f"w{i}" for i in rng.randint(4, VOCAB, size=lt)) + "\n")
                links = {(rng.randint(ls), j) for j in range(lt) for _ in range(rng.randint(1, 3))}
                fa.write(" ".join(f"{s}-{t}" for s, t in sorted(links)) + "\n")
    binarized = os.path.join(root, "bin")
    tpreprocess.cli_main(["-s", "en", "-t", "de", "--trainpref", os.path.join(raw, "train"), "--validpref",
                          os.path.join(raw, "valid"), "--destdir", binarized, "--srcdict", os.path.join(raw, "dict.txt"),
                          "--tgtdict", os.path.join(raw, "dict.txt"), "--align-suffix", "align"])
    # the text route of --load-alignments: <split>.en-de.align of Pharaoh pairs
    text = os.path.join(root, "text")
    tpreprocess.cli_main(["-s", "en", "-t", "de", "--trainpref", os.path.join(raw, "train"), "--validpref",
                          os.path.join(raw, "valid"), "--destdir", text, "--srcdict", os.path.join(raw, "dict.txt"),
                          "--tgtdict", os.path.join(raw, "dict.txt")])
    for split in ("train", "valid"):
        with open(os.path.join(raw, f"{split}.align")) as f, open(os.path.join(text, f"{split}.en-de.align"), "w") as g:
            g.write(f.read())
    return binarized, text


CASES = {
    "binarized": ("bin", dict(load_alignments=True)),
    "text_right_padded": ("text", dict(load_alignments=True, left_pad_source="False")),
    "truncate_source": ("bin", dict(load_alignments=True, truncate_source=True, max_source_positions=6)),
    "truncate_only": ("text", dict(truncate_source=True, max_source_positions=4)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_alignments_and_truncated_sources_collate_as_jax(case):
    """The translation task's datasets with --load-alignments (binarized by
    --align-suffix, or a Pharaoh text file) and --truncate-source: items,
    sizes and collated batches (align_weights included; padded to fixed
    shapes too) equal JAX's. A source cut by --truncate-source keeps
    links past its length, which JAX's collater indexes past the row with
    (IndexError, or a weight at another row's position; ROADMAP Queue C):
    the port drops them, so JAX is handed the items without them."""
    binarized, text = shared(SHARED_ROOT[0], "transformer_align_corpus", _write_mt_corpus)
    which, flags = CASES[case]
    data = binarized if which == "bin" else text
    base = dict(data=data, source_lang="en", target_lang="de", left_pad_source="True", left_pad_target="False",
                max_source_positions=1024, max_target_positions=1024, upsample_primary=1, dataset_impl=None,
                load_alignments=False, truncate_source=False)
    jargs, targs = argparse.Namespace(**{**base, **flags}), argparse.Namespace(**{**base, **flags})
    jtask, ttask = JaxTranslationTask.setup_task(jargs), TranslationTask.setup_task(targs)
    for split in ("train", "valid"):
        jtask.load_dataset(split)
        ttask.load_dataset(split)
        jds, tds = jtask.dataset(split), ttask.dataset(split)
        np.testing.assert_array_equal(np.asarray(tds.src_sizes), np.asarray(jds.src_sizes))
        for i in range(len(jds)):
            for key in ("source", "target", "alignment"):
                if key in jds[i]:
                    np.testing.assert_array_equal(tds[i][key], jds[i][key], err_msg=key)
        for pad_kwargs in ({}, dict(pad_to_src_len=16, pad_to_tgt_len=12, pad_to_bsz=8)):
            order = [3, 0, 5, 1]
            jitems = [dict(jds[i]) for i in order]
            for item in jitems:
                if "alignment" in item:
                    item["alignment"] = item["alignment"][item["alignment"][:, 0] < len(item["source"])]
            bw = jds.collater(jitems, **pad_kwargs)
            bg = tds.collater([tds[i] for i in order], **pad_kwargs)
            assert sorted(bg) == sorted(bw)
            for key in ("id", "target") + (("align_weights",) if "align_weights" in bw else ()):
                np.testing.assert_array_equal(bg[key], bw[key], err_msg=key)
            for key in bw["net_input"]:
                np.testing.assert_array_equal(bg["net_input"][key], bw["net_input"][key], err_msg=key)
    assert ("align_weights" in bg) == flags.get("load_alignments", False)
    assert isinstance(TorchDictionary.load(os.path.join(data, "dict.en.txt")), TorchDictionary)
    assert isinstance(JaxDictionary.load(os.path.join(data, "dict.en.txt")), JaxDictionary)
