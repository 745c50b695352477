"""PyTorch port, the training parser against JAX's: every option string
that JAX's ``parse_args_and_arch`` takes for a ported arch and its task is
either accepted by the port's, with the same value wherever both set the
dest, or refused with ``NotImplementedError`` naming its ROADMAP item.

Each flag is parsed alone on top of the arch's and task's base command
line, with a value that differs from its default where it takes one.
Component selectors (``--arch``, ``--task``, ``--criterion``, ...) and the
positional data directory are part of the base. ``--user-dir`` imports
a module at the parse in both packages: it names an empty package of the
test data (tests/data/fbk_user_dir_parity). The attention-route flags set a process-wide route in both
packages; each parse is followed by a reset. The generation parser's
flags of ROADMAP Queue A item 3 (``--sacrebleu``, ``--replace-unk``,
``--print-alignment``, ``--num-shards``, the codecs' own flags) are held
to JAX's values too."""

import argparse
import os

import numpy as np
import pytest

import fbk_fairseq_st_tpu.criterions.label_smoothed_cross_entropy_ctx_reg  # noqa: F401  (registers it)
import fbk_fairseq_st_tpu.models.vggtransformer  # noqa: F401  (registers the JAX models)
import fbk_fairseq_st_tpu.models.w2l_conv_glu  # noqa: F401  (registers the JAX model)
from fbk_fairseq_st_tpu.cli import infer as jinfer
import fbk_fairseq_st_tpu.models.conv_transformer_context  # noqa: F401  (registers the JAX model)
import fbk_fairseq_st_tpu.models.multilingual_conv_transformer  # noqa: F401  (registers the JAX model)
import fbk_fairseq_st_tpu.tasks.multilingual_speech_translation  # noqa: F401  (registers the JAX task)
import fbk_fairseq_st_tpu.models.transformer_align  # noqa: F401  (registers the JAX model)
import fbk_fairseq_st_tpu.models.transformer_lm  # noqa: F401  (registers the JAX model)
import fbk_fairseq_st_tpu.tasks.language_modeling  # noqa: F401  (registers the JAX task)
import fbk_fairseq_st_tpu.criterions.adaptive_loss  # noqa: F401  (registers the JAX criterion)
import fbk_fairseq_st_tpu.criterions.label_smoothed_cross_entropy_with_alignment  # noqa: F401
from fbk_fairseq_st_tpu import options as joptions
from fbk_fairseq_st_tpu.ops import attention as jattention
from fbk_fairseq_st_tpu_torch import options as toptions
from fbk_fairseq_st_tpu_torch.cli import infer as tinfer
from fbk_fairseq_st_tpu_torch.ops import attention as tattention

CASES = {
    "conv_transformer": ["--task", "speech_translation_with_transcription", "-s", "en", "-t", "de"],
    "conv_transformer_dualdecoder": ["--task", "speech_translation_dualdecoding", "-s", "en", "-t", "de"],
    "multitask_conv_transformer": ["--task", "speech_translation_multitask", "-t", "de"],
    "multilingual_conv_transformer": ["--task", "multilingual_speech_translation", "--lang-pairs", "en-de,en-nl"],
    "dynamicconv_iwslt_de_en": ["--task", "translation", "-s", "de", "-t", "en"],
    "conv_transformer_context": ["--task", "speech_recognition_context", "-t", "de", "--criterion",
                                 "label_smoothed_cross_entropy_ctxreg"],
    "vggtransformer_base": ["--task", "speech_recognition", "-t", "de"],
    "vggtransformer_enc_1": ["--task", "speech_recognition", "-t", "de", "--criterion", "ctc_loss"],
    "w2l_conv_glu_enc": ["--task", "speech_recognition", "-t", "de", "--criterion", "asg_loss"],
    "transformer_vaswani_wmt_en_de_big": ["--task", "translation", "-s", "de", "-t", "en"],
    "transformer_wmt_en_de_big_align": ["--task", "translation", "-s", "de", "-t", "en", "--criterion",
                                        "label_smoothed_cross_entropy_with_alignment"],
    "transformer_lm_wiki103": ["--task", "language_modeling", "--criterion", "adaptive_loss"],
}
# the archs of the translation task, which has --eval-bleu
TRANSLATION_ARCHS = ("dynamicconv_iwslt_de_en", "transformer_vaswani_wmt_en_de_big", "transformer_wmt_en_de_big_align")
# their JAX parsers have neither the transformer family's flags nor --relu-dropout
ASR_ARCHS = ("vggtransformer_base", "vggtransformer_enc_1", "w2l_conv_glu_enc")
SELECTORS = {"--arch", "-a", "--task", "--criterion", "--optimizer", "--lr-scheduler", "--tokenizer", "--bpe",
             "-h", "--help"}
# values in the formats the flags parse (lists, tuples, expressions, choices)
VALUES = {
    "--encoder-convolutions": "[(4, 3, 3)] * 2", "--encoder-kernel-size-list": "[3, 5]",
    "--decoder-kernel-size-list": "[3, 5]", "--lr": "0.5", "--update-freq": "2", "--adam-betas": "(0.8, 0.9)",
    "--lang-pairs": "en-de,en-fr", "--optimizer-overrides": "{'lr': 0.1}", "--jax-cache-dir": "none",
    "--max-tokens": "400", "--eval-bleu-args": "{}", "--eval-bleu-detok-args": "{}", "--encoder-glu": "False",
    "--decoder-glu": "False", "--weight-softmax": "False", "--left-pad-source": "False",
    "--left-pad-target": "True", "--adaptive-softmax-cutoff": "1000,4000",
}
# an empty package for --user-dir, in the repo's test data (one path, so
# every worker collects the same test ids, and nothing is written)
USER_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "fbk_user_dir_parity")
VALUES["--user-dir"] = USER_DIR


def _base(arch):
    criterion = [] if "--criterion" in CASES[arch] else ["--criterion", "label_smoothed_cross_entropy"]
    return ["/nonexistent", "--arch", arch, *criterion, *CASES[arch]]


def _reset_routes():
    jattention.set_flash_attention(None)
    tattention.set_flash_attention(None)


def _jax_parser(arch):
    parser = joptions.get_training_parser()
    joptions.parse_args_and_arch(parser, _base(arch), parse_known=True)
    _reset_routes()
    return parser


def _value(flag, action):
    """The command-line words that set ``action`` to other than its default."""
    if action.nargs == 0:
        return [flag]
    if flag in VALUES:
        return [flag, VALUES[flag]]
    if action.choices:
        return [flag, str(next(c for c in action.choices if c != action.default))]
    for candidate in ("3", "5", "0.375", "True", "x"):
        try:
            if action.type is None or action.type(candidate) != action.default:
                return [flag, candidate]
        except (TypeError, ValueError, SyntaxError):
            continue
    raise AssertionError(f"no value for {flag}")


def _parse(parse, argv):
    try:
        return parse(argv)
    finally:
        _reset_routes()


@pytest.mark.parametrize("arch", sorted(CASES))
def test_port_parser_takes_or_refuses_every_jax_flag(arch):
    """For every option string of JAX's training parser: the port's parser
    accepts it and sets each dest that JAX's sets to the same value, or
    raises NotImplementedError naming a ROADMAP Queue A item. The refused
    flag is steps-per-execution; the multi-GPU and the
    quant-noise and quantisation ones are taken."""
    jparser = _jax_parser(arch)
    refused, accepted = [], []
    for flag, action in sorted(jparser._option_string_actions.items()):
        if flag in SELECTORS or not flag.startswith("-"):
            continue
        argv = _base(arch) + _value(flag, action)
        try:
            targs = _parse(lambda a: toptions.parse_args_and_arch(toptions.get_training_parser(), a), argv)
        except NotImplementedError as e:
            assert "ROADMAP Queue A item" in str(e), (flag, str(e))
            refused.append(flag)
            continue
        except SystemExit:
            raise AssertionError(f"the port's parser refuses {argv[-2:]}")
        accepted.append(flag)
        jargs = _parse(lambda a: joptions.parse_args_and_arch(joptions.get_training_parser(), a), argv)
        for dest in sorted(set(vars(jargs)) & set(vars(targs))):
            want, got = getattr(jargs, dest), getattr(targs, dest)
            assert got == want or (isinstance(want, float) and np.isclose(got, want)), (flag, dest, got, want)
    assert len(accepted) > 100
    # the multi-GPU flags (ROADMAP Queue A item 6), ported
    assert not {"--use-bmuf", "--block-lr", "--distributed-coordinator", "--distributed-world-size", "--fsdp",
                "--sequence-parallel", "--ring-attention", "--distributed-num-processes"} & set(refused)
    assert {"--use-bmuf", "--block-lr", "--distributed-coordinator", "--distributed-world-size", "--fsdp",
            "--sequence-parallel", "--ring-attention", "--distributed-num-processes"} <= set(accepted)
    assert "--steps-per-execution" in refused
    # quant-noise and in-training quantisation (ROADMAP Queue A item 9(c)), ported
    assert not {"--quant-noise-pq", "--quant-noise-pq-block-size", "--quant-noise-scalar",
                "--quantization-config-path"} & set(refused)
    # the flags of ROADMAP Queue A item 3, ported
    assert {"--user-dir", "--allow-partial-restore", "--checkpoint-format", "--async-checkpoint"} <= set(accepted)
    pruning = {"--encoder-layers-to-keep", "--decoder-layers-to-keep"}  # the transformer family's
    assert (pruning <= set(accepted)) == (arch not in ASR_ARCHS)
    assert ("--eval-bleu" in accepted) == (arch in TRANSLATION_ARCHS)


GENERATION_FLAGS = [
    ["--sacrebleu"], ["--replace-unk"], ["--replace-unk", "align.txt"], ["--print-alignment"],
    ["--num-shards", "2", "--shard-id", "1"], ["--user-dir", USER_DIR],
    ["--tokenizer", "moses", "--moses-source-lang", "de", "--moses-no-dash-splits", "--moses-no-escape"],
    ["--tokenizer", "space"], ["--tokenizer", "nltk"], ["--bpe", "characters"], ["--bpe", "bytes"],
    ["--bpe", "sentencepiece", "--sentencepiece-vocab", "m.model"],
    ["--bpe", "subword_nmt", "--bpe-codes", "codes", "--bpe-separator", "++"],
    ["--bpe", "gpt2", "--gpt2-encoder-json", "e.json", "--gpt2-vocab-bpe", "v.bpe"],
    ["--bpe", "bert", "--bpe-cased", "--bpe-vocab-file", "vocab.txt"], ["--bpe", "fastbpe", "--bpe-codes", "c"],
    ["--bpe", "byte_bpe", "--sentencepiece-model-path", "m.model"],
    ["--bpe", "hf_byte_bpe", "--bpe-merges", "m.txt", "--bpe-vocab", "v.json", "--bpe-add-prefix-space"],
]


@pytest.mark.parametrize("extra", GENERATION_FLAGS,
                         ids=lambda e: "_".join(w for w in e[:2] if w != USER_DIR).lstrip("-"))
def test_ported_generation_flags_parse_as_jax(extra):
    """Each flag of the generation parser of ROADMAP Queue A item 3 (and
    each codec's own flags) parses to JAX's value, in every dest both
    namespaces have."""
    argv = ["/nonexistent", "--task", "speech_translation_with_transcription", "-s", "en", "-t", "de",
            "--path", "ckpt.pt"] + extra
    jargs = _parse(lambda a: joptions.parse_args_and_arch(joptions.get_generation_parser(), a), argv)
    targs = _parse(lambda a: toptions.parse_args_and_arch(toptions.get_generation_parser(), a), argv)
    shared = set(vars(jargs)) & set(vars(targs))
    for flag in extra:
        if flag.startswith("--"):
            assert flag[2:].replace("-", "_") in shared, flag
    for dest in sorted(shared):
        assert getattr(targs, dest) == getattr(jargs, dest), (dest, getattr(targs, dest), getattr(jargs, dest))


INFER_BASE = ["/nonexistent", "--task", "speech_recognition", "-t", "de", "--path", "ckpt.pt",
              "--results-path", "out"]


def test_port_infer_parser_takes_or_refuses_every_jax_flag():
    """For every option string of JAX's ``cli/infer`` parser (the
    generation parser and ``add_asr_eval_argument``): the port's accepts
    it and sets each dest that JAX's sets to the same value, or raises
    NotImplementedError naming a ROADMAP Queue A item (quantisation,
    several updates a dispatch, the NAT family's iterative refinement
    decoding)."""
    def jparse(a):
        return joptions.parse_args_and_arch(
            jinfer.add_asr_eval_argument(joptions.get_generation_parser(default_task="speech_recognition")), a)

    def tparse(a):
        return toptions.parse_args_and_arch(
            tinfer.add_asr_eval_argument(toptions.get_generation_parser(default_task="speech_recognition")), a)

    jparser = jinfer.add_asr_eval_argument(joptions.get_generation_parser(default_task="speech_recognition"))
    joptions.parse_args_and_arch(jparser, INFER_BASE, parse_known=True)
    _reset_routes()
    refused, accepted = [], []
    for flag, action in sorted(jparser._option_string_actions.items()):
        if flag in SELECTORS or not flag.startswith("-"):
            continue
        argv = INFER_BASE + _value(flag, action)
        try:
            targs = _parse(tparse, argv)
        except NotImplementedError as e:
            assert "ROADMAP Queue A item" in str(e), (flag, str(e))
            refused.append(flag)
            continue
        except SystemExit:
            raise AssertionError(f"the port's parser refuses {argv[-2:]}")
        accepted.append(flag)
        jargs = _parse(jparse, argv)
        for dest in sorted(set(vars(jargs)) & set(vars(targs))):
            want, got = getattr(jargs, dest), getattr(targs, dest)
            assert got == want or (isinstance(want, float) and np.isclose(got, want)), (flag, dest, got, want)
    assert set(refused) == {"--steps-per-execution",
                            "--decoding-format", "--iter-decode-eos-penalty",
                            "--iter-decode-max-iter", "--iter-decode-force-max-iter", "--iter-decode-with-beam",
                            "--iter-decode-with-external-reranker", "--retain-iter-history", "--print-step"}
    assert {"--ctc-decoding", "--w2l-decoder", "--lexicon", "--kenlm-model", "--lm-weight", "--word-score",
            "--beam-threshold", "--unk-weight", "--sil-weight", "--word-boundary-unit", "--ctc-beam-size"} <= set(
                accepted)


@pytest.mark.parametrize("arch", sorted(set(CASES) - set(ASR_ARCHS)))
def test_activation_dropout_is_relu_dropout(arch):
    """``--activation-dropout 0.3`` sets ``relu_dropout`` to 0.3 in both
    parsers (JAX's alias, ``models/transformer_args.py:19-21``), and
    ``--relu-dropout`` still does; no parser makes ``activation_dropout``
    a dest of its own (the wiki103 preset sets that attribute in both, and
    no layer reads it)."""
    for flag in ("--activation-dropout", "--relu-dropout"):
        argv = _base(arch) + [flag, "0.3"]
        jargs = _parse(lambda a: joptions.parse_args_and_arch(joptions.get_training_parser(), a), argv)
        targs = _parse(lambda a: toptions.parse_args_and_arch(toptions.get_training_parser(), a), argv)
        assert targs.relu_dropout == jargs.relu_dropout == 0.3
        assert getattr(targs, "activation_dropout", None) == getattr(jargs, "activation_dropout", None)
        assert hasattr(targs, "activation_dropout") == (arch == "transformer_lm_wiki103")


def test_attention_route_flags_set_the_route():
    """``--no-pallas-attention`` takes the dense route everywhere and
    ``--use-pallas-attention`` the flash route, as JAX's flags pick its
    XLA or its Pallas route."""
    import torch

    x = torch.zeros(1)
    base = _base("conv_transformer")
    try:
        toptions.parse_args_and_arch(toptions.get_training_parser(), base + ["--use-pallas-attention"])
        assert tattention.flash_enabled(x)
        toptions.parse_args_and_arch(toptions.get_training_parser(), base + ["--no-pallas-attention"])
        assert not tattention.flash_enabled(x)
    finally:
        _reset_routes()
    args = toptions.parse_args_and_arch(toptions.get_training_parser(), _base("conv_transformer") + [
        "--prng-impl", "threefry2x32", "--jax-cache-dir", "none", "--freeze-pretrained", "--encoder-layerdrop", "0.2"])
    assert isinstance(args, argparse.Namespace) and args.encoder_layerdrop == 0.2 and args.freeze_pretrained
