"""PyTorch port, multilingual ST (COLING 2020): the langtok and round-robin
datasets, ``multilingual_conv_transformer`` and its pair view, the weight
bridge, the multilingual criterion, three train steps, the warm start and
the CLIs against the JAX package on the same numpy inputs and weights, on
the CPU.

The models are tests/test_multilingual.py's ML_ARGS config (2+2 layers,
width 16, 2 heads, 8 mels, ``[(4, 3, 3)] * 2``); the JAX side's init and
forwards run under ``jax.jit``. The corpus (``audio-de`` and ``audio-nl``
over the same audio, plus ``audio`` transcripts) is written by the JAX
package's own CLIs (``create_multilingual_data``), once for the file.
Everything runs in fp32, the criterions in eval mode (dropout cannot
match bit for bit); tolerances are stated per test."""

import argparse
import functools
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fbk_fairseq_st_tpu.models.multilingual_conv_transformer  # noqa: F401  (registers the JAX model)
import fbk_fairseq_st_tpu.tasks.multilingual_speech_translation_kd  # noqa: F401  (registers the JAX tasks)
from fbk_fairseq_st_tpu import options as joptions
from fbk_fairseq_st_tpu import registry
from fbk_fairseq_st_tpu.cli import generate as jgenerate
from fbk_fairseq_st_tpu.cli import preprocess as jpreprocess
from fbk_fairseq_st_tpu.criterions import label_smoothed_cross_entropy as jlsce
from fbk_fairseq_st_tpu.models.multilingual_conv_transformer import _lang_token
from fbk_fairseq_st_tpu.registry import TASKS as JTASKS
from fbk_fairseq_st_tpu.tasks import multilingual_speech_translation as jmst
from fbk_fairseq_st_tpu.train.checkpoint import save_state
from fbk_fairseq_st_tpu.train.trainer import Trainer as JaxTrainer
from fbk_fairseq_st_tpu.utils.fairseq_interop import export_parameters
from fbk_fairseq_st_tpu_torch import options as toptions
from fbk_fairseq_st_tpu_torch.cli import generate as tgenerate
from fbk_fairseq_st_tpu_torch.cli import train as ttrain
from fbk_fairseq_st_tpu_torch.criterions import label_smoothed_cross_entropy as tlsce
from fbk_fairseq_st_tpu_torch.data import datasets as tdatasets
from fbk_fairseq_st_tpu_torch.data.knowledge_distillation import TeacherOutputDataset
from fbk_fairseq_st_tpu_torch.models import ARCHITECTURES
from fbk_fairseq_st_tpu_torch.models import multilingual_conv_transformer as tmct
from fbk_fairseq_st_tpu_torch.tasks import TASKS
from fbk_fairseq_st_tpu_torch.tasks import multilingual_speech_translation as tmst
from fbk_fairseq_st_tpu_torch.train import Trainer
from fbk_fairseq_st_tpu_torch.utils.weights import state_dict_from_jax

from .test_multilingual import ML_ARGS, create_multilingual_data
from .test_torch_model import random_variables, torch_dictionary
from .utils import dummy_dictionary, model_args

ARCH = "multilingual_conv_transformer"
PAIRS = ["audio-de", "audio-nl"]
LANGS = ["audio", "de", "nl"]
SMALL = dict(
    encoder_layers=2, decoder_layers=2, encoder_embed_dim=16, decoder_embed_dim=16, encoder_ffn_embed_dim=32,
    decoder_ffn_embed_dim=32, encoder_attention_heads=2, decoder_attention_heads=2,
    encoder_convolutions="[(4, 3, 3)] * 2", input_feat_per_channel=8, max_source_positions=64,
    max_target_positions=32,
)
VOCABS = {"de": 20, "nl": 24}  # one decoder a target dictionary: two sizes
SCORE_ATOL = 1e-4


def _np(x):
    return np.asarray(x.detach()) if isinstance(x, torch.Tensor) else np.asarray(x)


def _dicts(make):
    """{lang: dictionary} with the language tokens appended, as ``prepare``
    gives them; ``audio`` has none (its side is fbank frames)."""
    dicts = {}
    for lang, vocab in VOCABS.items():
        dicts[lang] = make(vocab)
        for other in LANGS:
            dicts[lang].add_symbol(_lang_token(other))
    return dicts


class _JaxTask:
    def __init__(self):
        self.dicts = _dicts(dummy_dictionary)


# (merge strategy, --encoder-langtok, --share-encoders, --share-decoders)
CASES = {
    "concat-tgt-shared_enc": ("concat", "tgt", True, False),
    "sum-src-shared_dec": ("sum", "src", False, True),
    "concat-off-shared_both": ("concat", None, True, True),
    "sum-tgt-unshared": ("sum", "tgt", False, False),
}


@functools.lru_cache(maxsize=None)
def built(case):
    """(JAX model, its variables as numpy, the port's model with them) of
    ``case``, once for the file."""
    merge, langtok, share_enc, share_dec = CASES[case]
    args = model_args(ARCH, lang_pairs=",".join(PAIRS), encoder_langtok=langtok, langtok_merge_strategy=merge,
                      share_encoders=share_enc, share_decoders=share_dec, **SMALL)
    registry.apply_architecture(args)
    jmodel = registry.build_model(args, _JaxTask())
    variables = random_variables(jmodel, 0)
    tmodel = tmct.build_model(ARCH, _dicts(torch_dictionary), device="cpu", lang_pairs=PAIRS,
                              encoder_langtok=langtok, langtok_merge_strategy=merge, share_encoders=share_enc,
                              share_decoders=share_dec, **SMALL)
    tmodel.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jmodel, variables, tmodel.eval()


def pair_batch(pair, seed=0, b=3, t=29, tgt_len=6, shared_decoder=False):
    """Unequal source lengths (one row of length 0, a bucket's padding row),
    a padded target tail, the target language's token first, over the
    dictionary of the pair's decoder (the first pair's when shared)."""
    rng = np.random.RandomState(seed)
    tgt_lang = pair.split("-")[1]
    vocab = VOCABS[PAIRS[0].split("-")[1] if shared_decoder else tgt_lang]
    tgt = rng.randint(4, 4 + vocab, size=(b, tgt_len)).astype(np.int32)
    tgt[1, -2:] = 1
    tgt[2, :] = 1
    bos = vocab + 4 + LANGS.index(tgt_lang)
    prev = np.concatenate([np.full((b, 1), bos, np.int32), tgt[:, :-1]], axis=1)
    prev[2, 0] = 1
    return {
        "src_tokens": rng.randn(b, t, 8).astype(np.float32),
        "src_lengths": np.array([t, t - 7, 0][:b], np.int32),
        "prev_output_tokens": prev,
        "target": tgt,
    }


def _torch_batch(batch):
    return {k: torch.tensor(v) if v.dtype == np.float32 else torch.tensor(v).long() for k, v in batch.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pair_logits_match_jax(case):
    """Eval mode, the same weights: each pair view's logits against JAX's
    ``pair_view(pair).forward`` within 1e-5, and the model's nested forward
    gives the same per pair; ``concat`` adds one frame to every row (the
    padding row too), ``sum`` none."""
    jmodel, variables, tmodel = built(case)
    merge = CASES[case][0]
    nested = {}
    for i, pair in enumerate(PAIRS):
        batch = pair_batch(pair, seed=i, shared_decoder=CASES[case][3])
        nested[pair] = _torch_batch(batch)
        (jlogits, _), _ = jax.jit(lambda v, b, p=pair: jmodel.pair_view(p).forward(v, b, training=False))(
            variables, {k: jnp.asarray(v) for k, v in batch.items()})
        with torch.no_grad():
            tlogits, extra = tmodel.pair_view(pair)(nested[pair])
        np.testing.assert_allclose(_np(tlogits), np.asarray(jlogits), rtol=0, atol=1e-5, err_msg=pair)
        want_lengths = batch["src_lengths"] + (1 if merge == "concat" and CASES[case][1] else 0)
        got_lengths = tmodel.apply_langtok(pair, nested[pair]["src_tokens"], nested[pair]["src_lengths"])[1]
        np.testing.assert_array_equal(_np(got_lengths), want_lengths)
    with torch.no_grad():
        outputs = tmodel(nested)
    assert list(outputs) == PAIRS
    for pair in PAIRS:
        with torch.no_grad():
            np.testing.assert_array_equal(_np(outputs[pair][0]), _np(tmodel.pair_view(pair)(nested[pair])[0]))


def test_bridge_matches_export_of_the_plain_model():
    """state_dict_from_jax names each encoder ``encoders.<key>.`` and each
    decoder ``decoders.<key>.`` followed by the names and values that
    ``export_parameters`` gives a plain conv_transformer with the same
    subtree; ``lang_embeddings`` is copied as it is; the state dict loads
    strictly."""
    _, variables, tmodel = built("sum-tgt-unshared")
    ours = state_dict_from_jax(variables)
    params, state = variables["params"], variables["state"]
    want = {"lang_embeddings": params["lang_embeddings"]}
    for key in params["encoders"]:
        plain = export_parameters({"params": {"encoder": params["encoders"][key]},
                                   "state": {"encoder": state["encoders"][key]}})
        want.update({f"encoders.{key}." + k[len("encoder."):]: v for k, v in plain.items()})
    for key in params["decoders"]:
        plain = export_parameters({"params": {"decoder": params["decoders"][key]}, "state": {}})
        want.update({f"decoders.{key}." + k[len("decoder."):]: v for k, v in plain.items()})
    assert sorted(ours) == sorted(want)
    assert {k.split(".")[1] for k in ours if k.startswith(("encoders.", "decoders."))} == {"audio", "de", "nl"}
    for name, arr in want.items():
        np.testing.assert_array_equal(ours[name].numpy(), np.asarray(arr), err_msg=name)
    assert sorted(tmodel.state_dict()) == sorted(ours)


@pytest.mark.parametrize("arch", sorted(tmct.ARCHITECTURES))
def test_arch_presets_match_jax(arch):
    """Each preset builds the JAX registry's encoder config and decoder
    configs (one a target language, the first pair's under
    ``--share-decoders``), field by field."""
    for share_dec in (False, True):
        args = model_args(arch, lang_pairs=",".join(PAIRS), share_decoders=share_dec)
        registry.apply_architecture(args)
        jmodel = registry.build_model(args, _JaxTask())
        enc, decs = tmct.configs(arch, _dicts(torch_dictionary), PAIRS, share_decoders=share_dec)
        assert ARCHITECTURES[arch] is tmct
        assert enc.frontend._asdict() == jmodel.encoder_cfg.frontend._asdict()
        assert {k: v for k, v in enc._asdict().items() if k != "frontend"} == {
            k: v for k, v in jmodel.encoder_cfg._asdict().items() if k != "frontend"}
        assert sorted(decs) == sorted(jmodel.decoder_cfgs)
        for key, dec in decs.items():
            jd = jmodel.decoder_cfgs[key]._asdict()
            assert dec._asdict() == {k: jd[k] for k in dec._fields}, key


class _JaxMLTask:
    lang_pairs = PAIRS


def test_multilingual_criterion_matches_jax():
    """``_MultilingualCriterion`` over ``label_smoothed_cross_entropy`` (0.1)
    on a nested batch, eval mode: the summed loss, the sample size and
    every ``<pair>:<key>`` and summed key within 1e-5 of JAX's, or 1e-6 of
    it for sums above 10 (fp32 rounding of a sum of ~70); a pair with no
    batch is skipped."""
    jmodel, variables, tmodel = built("concat-tgt-shared_enc")
    crit_args = argparse.Namespace(label_smoothing=0.1, sentence_avg=False)
    jtask = _JaxMLTask()
    jtask.target_dictionary = _JaxTask().dicts["de"]
    jc = jmst._MultilingualCriterion(jlsce.LabelSmoothedCrossEntropyCriterion(jtask, crit_args), jtask)
    ttask = argparse.Namespace(lang_pairs=PAIRS, target_dictionary=_dicts(torch_dictionary)["de"])
    tc = tmst._MultilingualCriterion(tlsce.LabelSmoothedCrossEntropyCriterion(ttask, crit_args), ttask)
    batches = {pair: pair_batch(pair, seed=5 + i) for i, pair in enumerate(PAIRS)}
    jloss, jss, jlog, _ = jax.jit(lambda v, b: jc(jmodel, v, b, training=False))(
        variables, {p: {k: jnp.asarray(v) for k, v in b.items()} for p, b in batches.items()})
    tloss, tss, tlog = tc(tmodel, {p: _torch_batch(b) for p, b in batches.items()}, training=False)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-6, atol=1e-5)
    assert int(tss) == int(jss)
    assert sorted(tlog) == sorted(jlog) and "audio-nl:nll_loss" in tlog
    for key, value in jlog.items():
        np.testing.assert_allclose(float(tlog[key]), float(value), rtol=1e-6, atol=1e-5, err_msg=key)
    _, one_ss, one_log = tc(tmodel, {PAIRS[1]: _torch_batch(batches[PAIRS[1]])}, training=False)
    assert int(one_ss) == int(tlog["audio-nl:sample_size"]) and not any(k.startswith(PAIRS[0]) for k in one_log)


# ---------------------------------------------------------------------------
# from files
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """tests/test_multilingual.py's corpus (8 train, 4 valid, 4 test
    utterances; ``de`` and ``nl`` targets) plus ``audio`` transcripts and
    their dictionary, written by the JAX package's CLIs."""
    data_dir = str(tmp_path_factory.mktemp("multilingual") / "data")
    create_multilingual_data(data_dir)
    rng = np.random.RandomState(99)
    for split, count in [("train", 8), ("valid", 4), ("test", 4)]:
        with open(os.path.join(data_dir, f"{split}_raw.audio"), "w") as f:
            for _ in range(count):
                f.write(" ".join(f"tr{rng.randint(10)}" for _ in range(rng.randint(2, 5))) + "\n")
    jpreprocess.cli_main(["--target-lang", "audio", "--trainpref", os.path.join(data_dir, "train_raw"),
                          "--validpref", os.path.join(data_dir, "valid_raw"),
                          "--testpref", os.path.join(data_dir, "test_raw"), "--destdir", data_dir,
                          "--dataset-impl", "cached"])
    return data_dir


def _argv(data_dir, *extra, task="multilingual_speech_translation"):
    argv = [data_dir] + ML_ARGS + list(extra)
    argv[argv.index("--task") + 1] = task
    return argv


def _tasks(argv, split):
    jargs = joptions.parse_args_and_arch(joptions.get_training_parser(), argv)
    jtask = JTASKS[jargs.task].setup_task(jargs)
    jtask.load_dataset(split)
    targs = toptions.parse_args_and_arch(toptions.get_training_parser(), argv + ["--cpu"])
    ttask = TASKS[targs.task].setup_task(targs)
    ttask.load_dataset(split)
    return jargs, jtask, targs, ttask


def _assert_batches_equal(got, want, where=""):
    assert sorted(got) == sorted(want), where
    for key, value in want.items():
        if isinstance(value, dict):
            _assert_batches_equal(got[key], value, f"{where}/{key}")
        elif value is None or isinstance(value, str):
            assert got[key] == value, f"{where}/{key}"
        else:
            np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(value), err_msg=f"{where}/{key}")


@pytest.mark.parametrize("langtok", ["concat-tgt", "sum-src-no_decoder_langtok"])
def test_nested_collation_matches_jax(corpus, langtok):
    """The train split collated by the port's task and by JAX's
    (``RoundRobinZipDatasets`` of ``LangtokFilterBanksToTextDataset``s):
    the same nested arrays, tags and counts, with and without a
    fixed-shape batch's padding rows (which keep pad as their first
    previous-output token); the same sizes, token counts and order."""
    extra = ["--langtok-merge-strategy", "concat"] if langtok == "concat-tgt" else [
        "--langtok-merge-strategy", "sum", "--encoder-langtok", "src"]
    argv = _argv(corpus, *extra)
    if langtok != "concat-tgt":
        argv.remove("--decoder-langtok")
    _, jtask, _, ttask = _tasks(argv, "train")
    jds, tds = jtask.dataset("train"), ttask.dataset("train")
    assert isinstance(tds, tdatasets.RoundRobinZipDatasets) and len(tds) == len(jds) == 8
    samples = [tds[i] for i in range(len(tds))]
    for pad in ({}, {"pad_to_src_len": 24, "pad_to_tgt_len": 8, "pad_to_bsz": 16}):
        want = jds.collater([jds[i] for i in range(len(jds))], **pad)
        got = tds.collater(samples, **pad)
        _assert_batches_equal(got, want)
        for pair in PAIRS:
            first = got[pair]["net_input"]["prev_output_tokens"][:, 0]
            lang = pair.split("-")[1]
            want_first = ttask.dicts[lang].index(f"__{lang}__") if langtok == "concat-tgt" else ttask.dicts[lang].eos()
            assert (first[:8] == want_first).all() and (first[8:] == 1).all()
    for i in range(len(tds)):
        assert tds.num_tokens(i) == jds.num_tokens(i)
        assert tds.max_component_size(i) == jds.max_component_size(i)
    np.testing.assert_array_equal(tds.ordered_indices(), jds.ordered_indices())


class _DeterministicJaxLSCE(jlsce.LabelSmoothedCrossEntropyCriterion):
    def __call__(self, model, variables, batch, rng=None, training=False):
        return super().__call__(model, variables, batch, rng=rng, training=False)


class _DeterministicLSCE(tlsce.LabelSmoothedCrossEntropyCriterion):
    def __call__(self, model, batch, generator=None, training=False):
        return super().__call__(model, batch, generator, training=False)


@pytest.fixture(scope="module")
def train_run(corpus, tmp_path_factory):
    """Three steps of JAX's Trainer and of the port's from the same weights
    on one nested batch of the corpus (collated to the shape buckets, as
    both CLIs batch), the criterions in eval mode; then JAX's trained
    weights saved as its pickled checkpoint (``save_state``)."""
    argv = _argv(corpus, "--langtok-merge-strategy", "concat", "--warmup-updates", "2")
    jargs, jtask, targs, ttask = _tasks(argv, "train")
    jmodel = registry.build_model(jargs, jtask)
    jtrainer = JaxTrainer(jargs, jtask, jmodel, jmst._MultilingualCriterion(_DeterministicJaxLSCE(jtask, jargs), jtask))
    gnorms = []
    log_training = jtrainer._log_training
    jtrainer._log_training = lambda lo, gnorm, meta: (gnorms.append(gnorm), log_training(lo, gnorm, meta))
    tmodel = ttask.build_model(targs, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jtrainer.variables())),
                           strict=True)
    ttrainer = Trainer(targs, ttask, tmodel, tmst._MultilingualCriterion(_DeterministicLSCE(ttask, targs), ttask))
    sample = next(iter(ttask.get_batch_iterator(ttask.dataset("train"), max_tokens=targs.max_tokens,
                                                max_positions=ttask.max_positions(), bucket_shapes=True,
                                                required_batch_size_multiple=8).next_epoch_itr(shuffle=False)))
    steps, lr_sum = [], 0.0
    for step in range(3):
        lr_sum += jtrainer.lr_scheduler.step_update(step)
        steps.append((jtrainer.train_step([sample]), ttrainer.train_step([sample]), gnorms[step]))
    variables = jax.tree_util.tree_map(np.asarray, jtrainer.variables())
    path = str(tmp_path_factory.mktemp("jax_trained") / "checkpoint_jax.pt")
    save_state(path, {"args": vars(jargs), "model": variables["params"], "model_state": variables["state"],
                      "extra_state": {"train_iterator": {"epoch": 1, "iterations_in_epoch": 0}, "val_loss": None}})
    return sample, steps, lr_sum, variables, ttrainer, path


def test_train_steps_match_jax_trainer(train_run):
    """Per step: the summed loss and nll_loss, each pair's, the counts and
    the gnorm at rtol 1e-5 (one backward over both pairs, divided by the
    summed sample size); then every parameter and BatchNorm buffer at atol
    1e-5 (the key-projection biases, whose exact gradient is 0, at 2 x the
    summed lr, as in tests/test_torch_train.py). The shared encoder's
    running stats took both pairs' batches."""
    sample, steps, lr_sum, variables, ttrainer, _ = train_run
    assert sorted(sample) == PAIRS
    for step, (want, got, jgnorm) in enumerate(steps):
        for key in ("loss", "nll_loss", "ntokens", "nsentences", "sample_size", "audio-de:loss", "audio-nl:loss",
                    "audio-nl:nll_loss"):
            np.testing.assert_allclose(float(got[key]), want[key], rtol=1e-5, err_msg=f"{key} step {step}")
        np.testing.assert_allclose(float(got["gnorm"]), jgnorm, rtol=1e-5, err_msg=f"gnorm step {step}")
    want_sd = state_dict_from_jax(variables)
    got_sd = ttrainer.model.state_dict()
    assert sorted(got_sd) == sorted(want_sd)
    for name, value in want_sd.items():
        atol = 2 * lr_sum if name.endswith("k_proj.bias") else 1e-5
        np.testing.assert_allclose(_np(got_sd[name]), value.numpy(), rtol=0, atol=atol, err_msg=name)


def _records(path):
    """{id: (score, text)} of the H- lines of a generate output file."""
    out = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            if line.startswith("H-"):
                head, score, text = line.rstrip("\n").split("\t")
                out[int(head[2:])] = (float(score), text)
    return out


def test_generate_one_pair_on_a_jax_trained_checkpoint_matches_jax(corpus, train_run, tmp_path):
    """``cli/generate -s audio -t de`` and ``-t nl`` (``--decoder-langtok``:
    the target's token as bos) on the JAX-trained checkpoint: the port's
    H- lines (``--cpu``) carry JAX ``cli/generate``'s tokens and scores
    within 1e-4 (base 2), beam 2, for both pairs of one model."""
    path = train_run[-1]
    for tgt in ("de", "nl"):
        argv = [corpus, "--task", "multilingual_speech_translation", "--lang-pairs", ",".join(PAIRS), "-s", "audio",
                "-t", tgt, "--langtok-merge-strategy", "concat", "--encoder-langtok", "tgt", "--decoder-langtok",
                "--path", path, "--beam", "2", "--max-tokens", "400", "--gen-subset", "test", "--max-len-b", "8"]
        jgenerate.cli_main(argv + ["--results-path", str(tmp_path / f"jax_{tgt}")])
        tgenerate.cli_main(argv + ["--results-path", str(tmp_path / f"port_{tgt}"), "--cpu"])
        want = _records(str(tmp_path / f"jax_{tgt}" / "generate-test.txt"))
        got = _records(str(tmp_path / f"port_{tgt}" / "generate-test.txt"))
        assert sorted(got) == sorted(want) == [0, 1, 2, 3], tgt
        for sid, (score, text) in want.items():
            assert got[sid][1] == text, (tgt, sid)
            assert abs(got[sid][0] - score) <= SCORE_ATOL, (tgt, sid)


def _pretrain_checkpoint(tmp_path, vocab=20):
    """A JAX conv_transformer's params on the dictionary without language
    tokens, pickled as tests/test_multilingual.py pickles them."""
    args = model_args("conv_transformer", **SMALL)
    registry.apply_architecture(args)

    class OldTask:
        target_dictionary = dummy_dictionary(vocab)
        source_dictionary = None

    pre = random_variables(registry.build_model(args, OldTask()), 1)
    path = str(tmp_path / "pre.pt")
    with open(path, "wb") as f:
        pickle.dump({"model": pre["params"]}, f)
    return path, pre


def _warm_model(path, allow_partial=False, **over):
    dicts = {lang: torch_dictionary(20) for lang in LANGS}
    for d in dicts.values():
        for lang in LANGS:
            d.add_symbol(_lang_token(lang))
    return tmct.build_model(ARCH, dicts, device="cpu", seed=2, lang_pairs=PAIRS, encoder_langtok="tgt",
                            langtok_merge_strategy="sum", share_encoders=True, pretrained_encoder=path,
                            pretrained_decoder=path, allow_partial_restore=allow_partial, **{**SMALL, **over})


def test_warm_start_grows_the_dictionaries(tmp_path):
    """tests/test_multilingual.py::test_pretrained_decoder_dict_resize in
    the port: from a JAX-pickled conv_transformer whose dictionary lacks
    the 3 language tokens, each decoder's embedding gets the old rows
    bitwise and keeps a non-zero fresh init in the 3 new ones; the encoder
    is copied exactly; the BatchNorm stats stay fresh. A checkpoint key the
    model lacks raises unless --allow-partial-restore; another shape
    mismatch raises."""
    path, pre = _pretrain_checkpoint(tmp_path)
    model = _warm_model(path)
    old = state_dict_from_jax({"params": pre["params"]})
    want_w = old["decoder.embed_tokens.weight"].numpy()
    for key in ("de", "nl"):
        new_w = _np(model.decoders[key].embed_tokens.weight)
        assert new_w.shape[0] == want_w.shape[0] + len(LANGS)
        np.testing.assert_array_equal(new_w[: want_w.shape[0]], want_w)
        assert np.abs(new_w[want_w.shape[0]:]).sum() > 0
    enc = model.encoders["shared"].state_dict()
    for name, value in old.items():
        if name.startswith("encoder."):
            np.testing.assert_array_equal(_np(enc[name[len("encoder."):]]), value.numpy(), err_msg=name)
    assert float(model.encoders["shared"].bn[0].running_var.min()) == 1.0

    extra = str(tmp_path / "extra.pt")
    with open(extra, "wb") as f:
        pickle.dump({"model": {**pre["params"], "encoder": {**pre["params"]["encoder"], "extra": np.ones(3)}}}, f)
    with pytest.raises(ValueError, match="unexpected keys"):
        _warm_model(extra)
    partial = _warm_model(extra, allow_partial=True)
    np.testing.assert_array_equal(_np(partial.encoders["shared"].fc3.weight), old["encoder.fc3.weight"].numpy())
    with pytest.raises(ValueError, match="Shape mismatch"):
        _warm_model(path, encoder_embed_dim=32, decoder_embed_dim=32)


def test_train_cli_under_both_merge_strategies(corpus, tmp_path):
    """The port's ``cli/train`` (``--cpu``) on the JAX-written corpus, as
    tests/test_multilingual.py trains it, under ``concat`` and ``sum``:
    ``checkpoint_last.pt`` is written, its args keep the pairs as a list,
    and the task's ``build_model`` rebuilds it (strict load)."""
    from fbk_fairseq_st_tpu_torch.train import checkpoint as tcheckpoint

    for merge in ("concat", "sum"):
        save_dir = str(tmp_path / merge)
        trainer, _ = ttrain.cli_main(_argv(corpus, "--save-dir", save_dir, "--langtok-merge-strategy", merge, "--cpu"))
        assert trainer.get_num_updates() > 0
        assert "checkpoint_last.pt" in os.listdir(save_dir)
        state = tcheckpoint.load_checkpoint_to_cpu(os.path.join(save_dir, "checkpoint_last.pt"))
        assert state["args"].lang_pairs == PAIRS and state["args"].langtok_merge_strategy == merge
        assert "lang_embeddings" in state["model"] and "encoders.shared.fc3.weight" in state["model"]


def test_with_transcr_carries_transcripts_and_trains(corpus, tmp_path):
    """``multilingual_speech_translation_with_transcr``: each pair's
    collated batch carries ``transcript_target`` (JAX's arrays), and the
    port's ``cli/train`` runs on it."""
    argv = _argv(corpus, task="multilingual_speech_translation_with_transcr")
    _, jtask, _, ttask = _tasks(argv, "train")
    jds, tds = jtask.dataset("train"), ttask.dataset("train")
    want, got = jds.collater([jds[0], jds[1]]), tds.collater([tds[0], tds[1]])
    for pair in PAIRS:
        assert "transcript_target" in got[pair]
    _assert_batches_equal(got, want)
    trainer, _ = ttrain.cli_main(argv + ["--save-dir", str(tmp_path / "transcr"), "--cpu"])
    assert trainer.get_num_updates() > 0


def test_kd_needs_the_teacher_files_then_trains(corpus, tmp_path):
    """``multilingual_speech_translation_with_transcr_kd`` fails with JAX's
    message without the teacher's files; with top-4 files for each target
    language (written with the port's ``TeacherOutputDataset.save_bin``
    into a copy of the corpus) ``cli/train`` runs one epoch."""
    import shutil

    data_dir = str(tmp_path / "data")
    shutil.copytree(corpus, data_dir)
    argv = _argv(data_dir, "--distill-topk", "4", "--kd-lambda", "0.5",
                 task="multilingual_speech_translation_with_transcr_kd")
    i = argv.index("--label-smoothing")
    argv[argv.index("--criterion") + 1] = "knowledge_distillation"
    del argv[i:i + 2]
    targs = toptions.parse_args_and_arch(toptions.get_training_parser(), argv + ["--cpu"])
    task = TASKS[targs.task].setup_task(targs)
    with pytest.raises(FileNotFoundError, match="Teacher datasets not found for pair audio-de split train"):
        task.load_dataset("train")
    rng = np.random.RandomState(4)
    for split in ("train", "valid"):
        for lang in ("de", "nl"):
            targets = task.dicts[lang]
            lengths = [len(t) for t in _target_items(data_dir, split, lang, targets)]
            prefix = os.path.join(data_dir, f"{split}.{lang}.top4")
            TeacherOutputDataset.save_bin(prefix + "_idx", [rng.randint(4, len(targets), size=(n, 4)) for n in lengths],
                                          np.int32)
            TeacherOutputDataset.save_bin(prefix + "_out", [rng.randn(n, 4).astype(np.float32) for n in lengths])
    trainer, _ = ttrain.cli_main(argv + ["--save-dir", str(tmp_path / "kd"), "--max-epoch", "1", "--cpu"])
    assert trainer.get_num_updates() > 0


def _target_items(data_dir, split, lang, dictionary):
    from fbk_fairseq_st_tpu_torch.data.indexed_dataset import load_indexed_dataset

    ds = load_indexed_dataset(os.path.join(data_dir, f"{split}.{lang}"), dictionary)
    return [ds[i] for i in range(len(ds))]


def test_langtok_names_and_refusals():
    """The language token's form and lookup; the multilingual presets in
    the registry; the parser takes the model's flags and
    ``--allow-partial-restore`` for every arch (the resume's partial
    restore)."""
    d = _dicts(torch_dictionary)["de"]
    assert tmct.lang_token("nl") == "__nl__" and tmct.lang_token_index(d, "nl") == d.index("__nl__")
    with pytest.raises(ValueError):
        tmct.lang_token_index(d, "fr")
    args = toptions.parse_args_and_arch(toptions.get_training_parser(), [
        "/nonexistent", "--task", "multilingual_speech_translation", "--lang-pairs", "en-de", "--arch", ARCH,
        "--share-encoders", "--share-decoder-embeddings", "--pretrained-encoder", "p.pt", "--allow-partial-restore",
        "--max-tokens", "10"])
    assert (args.share_encoders, args.share_decoder_embeddings, args.pretrained_encoder, args.allow_partial_restore) \
        == (True, True, "p.pt", True)
    assert toptions.parse_args_and_arch(toptions.get_training_parser(), [
        "/nonexistent", "--task", "speech_recognition", "--arch", "conv_transformer",
        "--allow-partial-restore"]).allow_partial_restore
