"""The argument groups of ``cli/train``, ``cli/validate``,
``cli/generate``, ``cli/interactive`` and ``cli/preprocess``, and the
two-pass parse.

Counterpart of ``fbk_fairseq_st_tpu/options.py``
(``get_preprocessing_parser`` :19, ``get_training_parser`` :25,
``get_generation_parser`` :35, ``get_interactive_generation_parser`` :44,
``get_validation_parser`` :56, ``get_parser`` :77, ``add_preprocess_args``
:187, ``add_dataset_args`` :220,
``add_distributed_training_args`` :258, ``add_optimization_args`` :376,
``add_checkpoint_args`` :399, ``add_common_eval_args`` :456,
``add_generation_args`` :490, ``add_interactive_args`` :568,
``parse_args_and_arch`` :593), under the same
flag names and defaults. ``parse_args_and_arch`` parses once to learn
``--arch``, ``--task``, ``--criterion``, ``--optimizer`` and
``--lr-scheduler``, adds their flags (the arch's as a group without
defaults, so the preset fills what is not given; the underlying
criterion's of ``ctc_multi_loss`` too), parses again and fills in the arch
preset's defaults. The model flags are the options each preset of the port
reads (``models.arch_defaults``), with JAX's explicit parser defaults
where it has them: as in JAX, the ``dynamicconv*`` presets then build
lightweight convolutions unless ``--encoder-conv-type`` /
``--decoder-conv-type dynamic`` is given (ROADMAP Queue C).

The port's parser takes every flag JAX's parser takes for the ported
archs and tasks. An option whose feature the port lacks raises
``NotImplementedError`` naming its ROADMAP item when it is set
(``NOT_PORTED``). JAX's flags that steer only XLA or the TPU
(``--prng-impl``, ``--jax-cache-dir``), its parity flags of the
reference's fp16 and DDP machinery and the fork's model flags that JAX
parses and never reads (``_FORK_MODEL_FLAGS``) are accepted and change
nothing, as in JAX; ``--activation-dropout`` is JAX's alias of
``--relu-dropout``; the context-aware presets define
``--freeze-pretrained`` with JAX's string choices, where the
conv_transformer family keeps JAX's inert store-true flag; ``--use-pallas-attention`` / ``--no-pallas-attention``
force the flash / the dense attention route, as JAX forces its Pallas
kernels' route. ``--adaptive-softmax-dropout`` is parsed and never
applied, as in JAX (ROADMAP Queue C, JAX side). ``get_eval_lm_parser``
is ``cli/eval_lm``'s (JAX :48, ``add_eval_lm_args`` :469).
"""

from __future__ import annotations

import argparse
import ast
import re
import sys
from typing import List, Optional

from . import registry
from .models import ARCHITECTURES, arch_defaults
from .models.conv_transformer_context import CHOICES as CONTEXT_CHOICES
from .models.transformer_lm import CHARACTER_FILTERS
from .optim import LR_SCHEDULERS, OPTIMIZERS
from .utils.user_dir import import_user_module

# option -> (its value when off, what it needs): set to anything else, it raises
NOT_PORTED = {
    "quantize_weights": ("none", "weight-only quantisation (ROADMAP Queue A item 9(c))"),
    "steps_per_execution": (1, "several updates a dispatch (ROADMAP Queue A item 8)"),
    "quantization_config_path": (None, "in-training quantisation (ROADMAP Queue A item 9(c))"),
    "quant_noise_pq": (0, "quant-noise training (ROADMAP Queue A item 9(c))"),
    "quant_noise_pq_block_size": (8, "quant-noise training (ROADMAP Queue A item 9(c))"),
    "quant_noise_scalar": (0, "quant-noise training (ROADMAP Queue A item 9(c))"),
    # the iterative refinement generator of the NAT family
    "decoding_format": (None, "the NAT family's decoding formats (ROADMAP Queue A item 9)"),
    "iter_decode_eos_penalty": (0.0, "iterative refinement decoding (ROADMAP Queue A item 9)"),
    "iter_decode_max_iter": (10, "iterative refinement decoding (ROADMAP Queue A item 9)"),
    "iter_decode_force_max_iter": (False, "iterative refinement decoding (ROADMAP Queue A item 9)"),
    "iter_decode_with_beam": (1, "iterative refinement decoding (ROADMAP Queue A item 9)"),
    "iter_decode_with_external_reranker": (False, "iterative refinement decoding (ROADMAP Queue A item 9)"),
    "retain_iter_history": (False, "iterative refinement decoding (ROADMAP Queue A item 9)"),
    "print_step": (False, "iterative refinement decoding (ROADMAP Queue A item 9)"),
}
# the JAX model parsers' explicit defaults, which win over a preset's
_TRANSFORMER_PARSER_DEFAULTS = {"encoder_layerdrop": 0, "decoder_layerdrop": 0, "no_cross_attention": False,
                                "cross_self_attention": False}
_MODEL_PARSER_DEFAULTS = {
    "conv_transformer": {"no_attn_2d": False, "distance_penalty": False, "init_variance": 1.0,
                         "ctc_compress_out": False, "ctc_compress_strategy": "avg"},
    "lightconv": {"encoder_glu": None, "decoder_glu": None, "encoder_conv_type": "lightweight",
                  "decoder_conv_type": "lightweight", "weight_softmax": True},
    "transformer": _TRANSFORMER_PARSER_DEFAULTS,
    "transformer_align": _TRANSFORMER_PARSER_DEFAULTS,
    "transformer_lm": {**_TRANSFORMER_PARSER_DEFAULTS, "character_embeddings": False,
                       "character_embedding_dim": 4, "char_embedder_highway_layers": 2,
                       "character_filters": CHARACTER_FILTERS},
}
_EVAL_BOOL = ("encoder_glu", "decoder_glu", "weight_softmax")
# the JAX model parsers' flags that no preset of the port reads (flag ->
# JAX's argparse keywords), by family: parsed and never read, as in JAX,
# or a feature of another item (NOT_PORTED). Both families take JAX's
# ``add_transformer_args``; a flag a preset reads keeps the preset's.
_TRANSFORMER_FLAGS = {
    "--activation-fn": dict(choices=["gelu", "gelu_accurate", "linear", "relu", "tanh"]),
    "--encoder-embed-path": dict(type=str),
    "--decoder-embed-path": dict(type=str),
    "--decoder-output-dim": dict(type=int),
    "--share-all-embeddings": dict(action="store_true"),
    "--layernorm-embedding": dict(action="store_true"),
    "--no-scale-embedding": dict(action="store_true"),
    "--encoder-layerdrop": dict(type=float, default=0),
    "--decoder-layerdrop": dict(type=float, default=0),
    "--no-cross-attention": dict(action="store_true", default=False),
    "--cross-self-attention": dict(action="store_true", default=False),
    "--encoder-layers-to-keep": dict(default=None),
    "--decoder-layers-to-keep": dict(default=None),
    "--adaptive-softmax-dropout": dict(type=float),
    "--quant-noise-pq": dict(type=float, default=0),
    "--quant-noise-pq-block-size": dict(type=int, default=8),
    "--quant-noise-scalar": dict(type=float, default=0),
}
_FORK_MODEL_FLAGS = {
    "conv_transformer": {**_TRANSFORMER_FLAGS, "--normalization-constant": dict(type=float, default=1.0),
                         "--freeze-pretrained": dict(action="store_true")},
    "lightconv": _TRANSFORMER_FLAGS,
    "transformer": _TRANSFORMER_FLAGS,
    "transformer_align": _TRANSFORMER_FLAGS,
    # the LM's parser has every add_transformer_args flag, the encoder's too
    "transformer_lm": {**_TRANSFORMER_FLAGS, "--decoder-input-dim": dict(type=int),
                       **{f"--encoder-{name}": dict(type=int) for name in ("embed-dim", "ffn-embed-dim", "layers",
                                                                           "attention-heads")},
                       "--encoder-normalize-before": dict(action="store_true"),
                       "--encoder-learned-pos": dict(action="store_true")},
    "vggtransformer": {},
    "w2l_conv_glu": {},
}
# a preset option's other flags (JAX's aliases)
_ALIASES = {"relu_dropout": ("--activation-dropout",)}
# preset options whose flag JAX's parser defines otherwise than the
# preset's value type says (a kernel list stays the string JAX keeps)
_FLAG_KWARGS = {"distance_penalty": dict(type=str, choices=["log", "gauss"]),
                "encoder_kernel_size_list": dict(type=str), "decoder_kernel_size_list": dict(type=str),
                **{name: dict(type=str, choices=list(choices)) for name, choices in CONTEXT_CHOICES.items()}}
# preset options that another component's flag sets (the criterion's and
# ASG's --asg-transitions-init, the context task's --context-type), or that
# no flag sets (the wiki103 preset's activation_dropout: --activation-dropout
# is --relu-dropout's alias): no model flag
_NOT_MODEL_FLAGS = ("criterion", "context_type", "asg_transitions_init", "activation_dropout")


def get_preprocessing_parser(default_task: str = "translation") -> argparse.ArgumentParser:
    parser = get_parser("Preprocessing", default_task)
    add_preprocess_args(parser)
    return parser


def get_training_parser(default_task: str = "speech_recognition") -> argparse.ArgumentParser:
    parser = get_parser("Trainer", default_task)
    add_dataset_args(parser, train=True)
    add_distributed_training_args(parser)
    add_model_args(parser)
    add_optimization_args(parser)
    add_checkpoint_args(parser)
    return parser


def get_eval_lm_parser(default_task: str = "language_modeling") -> argparse.ArgumentParser:
    parser = get_parser("Evaluate Language Model", default_task)
    add_dataset_args(parser, gen=True)
    add_distributed_training_args(parser)
    add_eval_lm_args(parser)
    return parser


def add_eval_lm_args(parser):
    group = parser.add_argument_group("LM Evaluation")
    add_common_eval_args(group)
    group.add_argument("--output-word-probs", action="store_true",
                       help="print each word with its log-probability")
    group.add_argument("--output-word-stats", action="store_true",
                       help="log each word's count and mean log-probability, by count")
    group.add_argument("--context-window", default=0, type=int, metavar="N",
                       help="score each window with up to N tokens of the rows before as context")
    group.add_argument("--softmax-batch", default=sys.maxsize, type=int, metavar="N",
                       help="parity flag: the scorer takes the whole softmax")
    return group


def get_validation_parser(default_task: str = "speech_recognition") -> argparse.ArgumentParser:
    parser = get_parser("Validation", default_task)
    add_dataset_args(parser, train=True)
    group = parser.add_argument_group("Evaluation")
    add_common_eval_args(group)
    return parser


def eval_str_list(x, type=float):
    if x is None:
        return None
    if isinstance(x, str):
        x = ast.literal_eval(x)
    try:
        return list(map(type, x))
    except TypeError:
        return [type(x)]


def eval_bool(x) -> bool:
    return str(x).lower() == "true"


def _number(x: str):
    return int(x) if re.fullmatch(r"[+-]?\d+", x.strip()) else float(x)


def get_generation_parser(default_task: str = "speech_recognition", interactive: bool = False
                          ) -> argparse.ArgumentParser:
    parser = get_parser("Generation", default_task)
    add_dataset_args(parser, gen=True)
    add_generation_args(parser)
    if interactive:
        add_interactive_args(parser)
    return parser


def get_interactive_generation_parser(default_task: str = "speech_recognition") -> argparse.ArgumentParser:
    return get_generation_parser(default_task, interactive=True)


def get_parser(desc: str, default_task: str = "speech_recognition") -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(allow_abbrev=False, description=desc)
    parser.add_argument("--no-progress-bar", action="store_true", help="disable progress bar")
    parser.add_argument("--log-interval", type=int, default=100, metavar="N",
                        help="log progress every N batches")
    parser.add_argument("--log-format", default=None, choices=["json", "none", "simple", "tqdm"])
    parser.add_argument("--profile", action="store_true", default=False,
                        help="record a torch.profiler trace of the run to <save-dir>/profile")
    parser.add_argument("--use-pallas-attention", action="store_true", default=False,
                        help="force the flash attention route (JAX: its Pallas kernels) everywhere")
    parser.add_argument("--no-pallas-attention", action="store_true", default=False,
                        help="take the dense attention route everywhere")
    parser.add_argument("--prng-impl", default="rbg", choices=["rbg", "threefry2x32"],
                        help="parity flag: JAX's dropout PRNG (the port draws from torch generators and Philox)")
    parser.add_argument("--device-prefetch", type=int, default=2, metavar="N",
                        help="stage N collated batches on the card ahead of the step (0 disables)")
    parser.add_argument("--log-sync-interval", type=int, default=1, metavar="N",
                        help="parity flag: the trainer brings its outputs to the host at --log-interval, "
                             "before validating and before saving")
    parser.add_argument("--steps-per-execution", type=int, default=1, metavar="K",
                        help="several updates a dispatch (not ported)")
    parser.add_argument("--tensorboard-logdir", metavar="DIR", default="",
                        help="path to save logs for tensorboard")
    parser.add_argument("--seed", default=1, type=int, metavar="N", help="pseudo random number generator seed")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU instead of the CUDA card")
    parser.add_argument("--jax-cache-dir", metavar="DIR", default=None, help="parity flag: XLA's compilation cache")
    parser.add_argument("--fp16", action="store_true", help="use mixed precision (bfloat16 here)")
    parser.add_argument("--bf16", action="store_true", help="use bfloat16 compute (params stay fp32)")
    parser.add_argument("--memory-efficient-fp16", action="store_true", help="parity flag; same as --fp16 here")
    parser.add_argument("--fp16-no-flatten-grads", action="store_true", help="parity flag")
    for flag in ("--fp16-init-scale", "--fp16-scale-tolerance", "--min-loss-scale", "--threshold-loss-scale"):
        parser.add_argument(flag, type=float, default=None, help="parity flag; no loss scaler under bf16")
    parser.add_argument("--fp16-scale-window", type=int, default=None, help="parity flag; no loss scaler under bf16")
    parser.add_argument("--empty-cache-freq", default=0, type=int, help="parity flag")
    parser.add_argument("--all-gather-list-size", default=16384, type=int, help="parity flag")
    parser.add_argument("--model-parallel-size", type=int, metavar="N", default=1,
                        help="tensor parallelism: the mesh's 'model' dim")
    parser.add_argument("--checkpoint-suffix", default="", help="suffix to add to the checkpoint file name before .pt")
    parser.add_argument("--quantization-config-path", default=None, help="in-training quantisation (not ported)")
    parser.add_argument("--user-dir", default=None,
                        help="path to a python module containing custom extensions (tasks and/or architectures)")
    parser.add_argument("--tokenizer", default=None, help="tokenizer applied to raw text before BPE")
    parser.add_argument("--bpe", default=None, help="subword codec applied after the tokenizer")
    parser.add_argument("--task", metavar="TASK", default=default_task, help="task")
    parser.add_argument("--criterion", default="cross_entropy", metavar="CRIT")
    parser.add_argument("--optimizer", default="nag", metavar="OPT")
    parser.add_argument("--lr-scheduler", default="fixed", metavar="SCHED")
    return parser


def add_preprocess_args(parser):
    group = parser.add_argument_group("Preprocessing")
    group.add_argument("-s", "--source-lang", default=None, metavar="SRC")
    group.add_argument("-t", "--target-lang", default=None, metavar="TARGET")
    group.add_argument("--trainpref", metavar="FP", default=None)
    group.add_argument("--validpref", metavar="FP", default=None)
    group.add_argument("--testpref", metavar="FP", default=None)
    group.add_argument("--destdir", metavar="DIR", default="data-bin")
    group.add_argument("--thresholdtgt", metavar="N", default=0, type=int)
    group.add_argument("--thresholdsrc", metavar="N", default=0, type=int)
    group.add_argument("--tgtdict", metavar="FP", default=None)
    group.add_argument("--srcdict", metavar="FP", default=None)
    group.add_argument("--nwordstgt", metavar="N", default=-1, type=int)
    group.add_argument("--nwordssrc", metavar="N", default=-1, type=int)
    group.add_argument("--align-suffix", metavar="FP", default=None,
                       help="binarize {train,valid,test}pref.SUFFIX (Pharaoh 'si-ti' pairs) into "
                            "{split}.align.src-tgt datasets")
    group.add_argument("--alignfile", metavar="ALIGN", default=None,
                       help="train-split alignment file: write the alignment.src-tgt.txt dictionary "
                            "(the most frequent target word of each source word)")
    group.add_argument("--only-source", action="store_true")
    group.add_argument("--padding-factor", metavar="N", default=8, type=int)
    group.add_argument("--dataset-impl", metavar="FORMAT", default="mmap", choices=["raw", "lazy", "cached", "mmap"])
    group.add_argument("--joined-dictionary", action="store_true")
    group.add_argument("--workers", metavar="N", default=1, type=int,
                       help="parity flag: the files are written by one process, as JAX writes them")
    return group


def add_dataset_args(parser, train: bool = False, gen: bool = False):
    group = parser.add_argument_group("Dataset and data loading")
    group.add_argument("--num-workers", default=1, type=int, metavar="N",
                       help="how many subprocesses to use for data loading")
    group.add_argument("--skip-invalid-size-inputs-valid-test", action="store_true",
                       help="ignore too-long or too-short lines in valid and test set")
    group.add_argument("--max-tokens", type=int, metavar="N", help="maximum number of tokens in a batch")
    group.add_argument("--max-sentences", "--batch-size", type=int, metavar="N",
                       help="maximum number of sentences in a batch")
    group.add_argument("--required-batch-size-multiple", default=8, type=int, metavar="N",
                       help="batch size will be a multiplier of this value")
    group.add_argument("--dataset-impl", metavar="FORMAT", choices=["raw", "lazy", "cached", "mmap"],
                       help="output dataset implementation")
    group.add_argument("--data-buffer-size", default=2, type=int, help="number of batches to preload")
    if train:
        group.add_argument("--train-subset", default="train", metavar="SPLIT",
                           help="data subset to use for training")
        group.add_argument("--valid-subset", default="valid", metavar="SPLIT",
                           help="comma separated list of data subsets to use for validation")
        group.add_argument("--validate-interval", type=int, default=1, metavar="N", help="validate every N epochs")
        group.add_argument("--fixed-validation-seed", default=None, type=int, metavar="N")
        group.add_argument("--disable-validation", action="store_true")
        group.add_argument("--max-tokens-valid", type=int, metavar="N")
        group.add_argument("--max-sentences-valid", type=int, metavar="N")
        group.add_argument("--curriculum", default=0, type=int, metavar="N")
    if gen:
        group.add_argument("--gen-subset", default="test", metavar="SPLIT",
                           help="data subset to generate (train, valid, test)")
        group.add_argument("--num-shards", default=1, type=int, metavar="N")
        group.add_argument("--shard-id", default=0, type=int, metavar="ID")
    return group


def add_distributed_training_args(parser):
    """JAX's group: the ranks, their mesh and the multi-host rendezvous
    (``cli/train.py::Launch``, ``train/trainer.py``, ``parallel/``); the
    reference's DDP knobs are parity flags, as in JAX."""
    group = parser.add_argument_group("Distributed training")
    group.add_argument("--distributed-world-size", type=int, metavar="N", default=None,
                       help="total number of ranks, one a GPU (gloo processes with --cpu)")
    group.add_argument("--distributed-rank", default=0, type=int, help="parity flag")
    group.add_argument("--dcn-data-parallel", type=int, default=1, metavar="N",
                       help="an outer 'dcn' mesh dim: the batch splits over dcn x data, FSDP's chunks stay inside "
                            "a dcn slice")
    group.add_argument("--fsdp", default=False, action="store_true",
                       help="ZeRO-3: leaves of at least --fsdp-min-shard-size elements held in chunks over 'data'")
    group.add_argument("--fsdp-min-shard-size", type=int, default=None, metavar="N")
    group.add_argument("--sequence-parallel", default=False, action="store_true",
                       help="with --model-parallel-size > 1, split the LayerNorm/dropout/residual segments over time")
    group.add_argument("--ring-attention", default=False, action="store_true",
                       help="with --model-parallel-size > 1, split self-attention's sequence over the model ranks "
                            "(ring attention on the flash kernels)")
    group.add_argument("--ddp-backend", default="pjit", help="parity flag")
    group.add_argument("--distributed-backend", default="pjit", metavar="BACKEND",
                       help="nccl or gloo (pjit, the JAX default: nccl on the GPUs, gloo with --cpu)")
    group.add_argument("--distributed-init-method", default=None,
                       help="the rendezvous, tcp://HOST:PORT or file://PATH (default: a free port on this host)")
    group.add_argument("--distributed-port", default=-1, type=int,
                       help="the rendezvous port on this host, without --distributed-init-method")
    group.add_argument("--device-id", "--local_rank", default=0, type=int,
                       help="this process's local rank with --distributed-no-spawn")
    group.add_argument("--distributed-no-spawn", action="store_true",
                       help="run one rank in this process (--device-id) instead of spawning this host's ranks")
    group.add_argument("--nprocs-per-node", type=int, default=None, help="parity flag")
    group.add_argument("--fix-batches-to-gpus", action="store_true", help="parity flag")
    group.add_argument("--bucket-cap-mb", default=25, type=int, metavar="MB",
                       help="parity flag: the gradients go in one all-reduce")
    group.add_argument("--broadcast-buffers", action="store_true", help="parity flag")
    group.add_argument("--find-unused-parameters", action="store_true", help="parity flag")
    group.add_argument("--fast-stat-sync", action="store_true", help="parity flag")
    group.add_argument("--distributed-wrapper", default="DDP", choices=["DDP", "SlowMo"], help="parity flag")
    group.add_argument("--slowmo-momentum", default=None, type=float, help="parity flag")
    group.add_argument("--slowmo-algorithm", default="LocalSGD", choices=["LocalSGD", "SGP"], help="parity flag")
    group.add_argument("--localsgd-frequency", default=3, type=int, help="parity flag")
    group.add_argument("--distributed-coordinator", default=None, metavar="HOST:PORT",
                       help="the hosts' rendezvous (reference --distributed-init-method)")
    group.add_argument("--distributed-num-processes", type=int, default=None, metavar="N",
                       help="the number of host processes of a multi-host run")
    group.add_argument("--distributed-process-id", type=int, default=None, metavar="I",
                       help="this host process's index")
    group.add_argument("--distributed-local-device-ids", default=None, metavar="IDS",
                       help="this host's GPUs, comma-separated: a rank each")
    return group


def add_optimization_args(parser):
    group = parser.add_argument_group("Optimization")
    group.add_argument("--max-epoch", "--me", default=0, type=int, metavar="N",
                       help="force stop training at specified epoch")
    group.add_argument("--max-update", "--mu", default=0, type=int, metavar="N",
                       help="force stop training at specified update")
    group.add_argument("--clip-norm", default=25, type=float, metavar="NORM", help="clip threshold of gradients")
    group.add_argument("--sentence-avg", action="store_true",
                       help="normalize gradients by the number of sentences in a batch"
                       " (default is to normalize by number of tokens)")
    group.add_argument("--update-freq", default="1", metavar="N1,N2,...,N_K",
                       type=lambda uf: eval_str_list(uf, type=int),
                       help="update parameters every N_i batches, when in epoch i")
    group.add_argument("--lr", "--learning-rate", default="0.25", metavar="LR_1,LR_2,...,LR_N",
                       type=lambda lr: eval_str_list(lr, type=float),
                       help="learning rate for the first N epochs")
    group.add_argument("--min-lr", default=-1, type=float, metavar="LR",
                       help="stop training when the learning rate reaches this minimum")
    group.add_argument("--use-bmuf", default=False, action="store_true",
                       help="local SGD with BMUF block syncs (optim/local_sgd.py)")
    group.add_argument("--block-lr", default=1.0, type=float, help="block learning rate for bmuf")
    group.add_argument("--block-momentum", default=0.875, type=float, help="block momentum for bmuf")
    group.add_argument("--global-sync-iter", default=50, type=int, help="iterations between global model syncs")
    group.add_argument("--warmup-iterations", default=500, type=int,
                       help="warmup iterations before block updates start")
    group.add_argument("--use-nbm", action="store_true", default=False, help="use Nesterov-style block momentum")
    group.add_argument("--average-sync", action="store_true", default=False,
                       help="average optimizer state at sync points")
    return group


def add_checkpoint_args(parser):
    group = parser.add_argument_group("Checkpointing")
    group.add_argument("--save-dir", metavar="DIR", default="checkpoints", help="path to save checkpoints")
    group.add_argument("--restore-file", default="checkpoint_last.pt", help="filename from which to load checkpoint")
    group.add_argument("--reset-dataloader", action="store_true")
    group.add_argument("--reset-lr-scheduler", action="store_true")
    group.add_argument("--allow-partial-restore", action="store_true",
                       help="restore the parameters the checkpoint and the model share: the model's others keep "
                            "their initialisation, the checkpoint's others are dropped")
    group.add_argument("--reset-meters", action="store_true")
    group.add_argument("--reset-optimizer", action="store_true")
    group.add_argument("--optimizer-overrides", default="{}", type=str, metavar="DICT")
    group.add_argument("--save-interval", type=int, default=1, metavar="N", help="save a checkpoint every N epochs")
    group.add_argument("--save-interval-updates", type=int, default=0, metavar="N",
                       help="save a checkpoint (and validate) every N updates")
    group.add_argument("--keep-interval-updates", type=int, default=-1, metavar="N")
    group.add_argument("--keep-last-epochs", type=int, default=-1, metavar="N")
    group.add_argument("--keep-best-checkpoints", type=int, default=-1, metavar="N")
    group.add_argument("--no-save", action="store_true")
    group.add_argument("--no-epoch-checkpoints", action="store_true")
    group.add_argument("--no-last-checkpoints", action="store_true")
    group.add_argument("--save-on-interrupt", dest="save_on_interrupt", action="store_true", default=True,
                       help="on SIGTERM/SIGINT, finish the update in flight, write checkpoint_last and exit")
    group.add_argument("--no-save-on-interrupt", dest="save_on_interrupt", action="store_false")
    group.add_argument("--no-save-optimizer-state", action="store_true")
    group.add_argument("--best-checkpoint-metric", type=str, default="loss")
    group.add_argument("--maximize-best-checkpoint-metric", action="store_true")
    group.add_argument("--patience", type=int, default=-1, metavar="N",
                       help="early stop training if valid performance doesn't improve for N consecutive "
                       "validation runs")
    group.add_argument("--checkpoint-format", choices=["pickle", "sharded"], default="pickle",
                       help="pickle: one file (the fork's torch.save layout here); sharded: JAX's directory of "
                            "meta.pkl and one .npy a leaf")
    group.add_argument("--async-checkpoint", action="store_true",
                       help="with --checkpoint-format sharded: write the files on a background thread")
    return group


def add_model_args(parser):
    group = parser.add_argument_group("Model configuration")
    group.add_argument("--arch", "-a", default="fconv", metavar="ARCH", help="model architecture")
    return group


def _add_arch_args(parser, arch: str) -> None:
    """The options the preset ``arch`` reads, as flags without defaults
    (the preset fills what is not given), but for the JAX parser's explicit
    defaults; flags the parser already has (the task's
    ``--max-source-positions``, the criterion's ``--ctc-encoder-layer``)
    keep their definition. Then the family's flags of JAX's model parser
    that no preset reads (``_FORK_MODEL_FLAGS``)."""
    group = parser.add_argument_group("Model-specific configuration", argument_default=argparse.SUPPRESS)
    family = _family_name(arch)
    if family not in _FORK_MODEL_FLAGS:  # the conv_transformer-based families
        family = "conv_transformer"
    explicit = _MODEL_PARSER_DEFAULTS.get(family, {})
    for name, value in arch_defaults(arch).items():
        flag = "--" + name.replace("_", "-")
        if name in _NOT_MODEL_FLAGS or flag in parser._option_string_actions:
            continue
        kwargs = {"default": explicit[name]} if name in explicit else {}
        flags = (flag, *_ALIASES.get(name, ()))
        if name in _FLAG_KWARGS:
            group.add_argument(*flags, dest=name, **_FLAG_KWARGS[name], **kwargs)
        elif name in _EVAL_BOOL:
            group.add_argument(*flags, dest=name, type=eval_bool, **kwargs)
        elif isinstance(value, bool):
            group.add_argument(*flags, dest=name, action="store_true", **kwargs)
        elif isinstance(value, list):
            group.add_argument(*flags, dest=name, type=lambda x: eval_str_list(x, int), **kwargs)
        elif isinstance(value, (int, float)):
            group.add_argument(*flags, dest=name, type=_number, **kwargs)
        else:
            group.add_argument(*flags, dest=name, type=str, **kwargs)
    for flag, kwargs in _FORK_MODEL_FLAGS[family].items():
        if flag not in parser._option_string_actions:
            group.add_argument(flag, **kwargs)


def _family_name(arch) -> Optional[str]:
    """The port's model family (its module's name) of ``arch``, None for an arch it lacks."""
    return ARCHITECTURES[arch].__name__.rsplit(".", 1)[-1] if arch in ARCHITECTURES else None


def add_common_eval_args(group) -> None:
    group.add_argument("--path", metavar="FILE", help="path(s) to model file(s), colon separated")
    group.add_argument("--remove-bpe", "--post-process", nargs="?", const="@@ ", default=None,
                       help="remove BPE tokens before scoring")
    group.add_argument("--quiet", action="store_true", help="only print final scores")
    group.add_argument("--model-overrides", default="{}", type=str, metavar="DICT")
    group.add_argument("--results-path", metavar="RESDIR", type=str, default=None)


def add_generation_args(parser):
    group = parser.add_argument_group("Generation")
    add_common_eval_args(group)
    group.add_argument("--quantize-weights", choices=["none", "int8"], default="none",
                       help="weight-only quantization of linear layers for serving")
    group.add_argument("--beam", default=5, type=int, metavar="N", help="beam size")
    group.add_argument("--nbest", default=1, type=int, metavar="N", help="number of hypotheses to output")
    group.add_argument("--max-len-a", default=0, type=float, metavar="N")
    group.add_argument("--max-len-b", default=200, type=int, metavar="N",
                       help="generate sequences of maximum length ax + b")
    group.add_argument("--min-len", default=1, type=float, metavar="N")
    group.add_argument("--match-source-len", default=False, action="store_true")
    group.add_argument("--no-early-stop", action="store_true")
    group.add_argument("--unnormalized", action="store_true", help="compare unnormalized hypothesis scores")
    group.add_argument("--no-beamable-mm", action="store_true")
    group.add_argument("--lenpen", default=1, type=float, help="length penalty: >1.0 favors longer sentences")
    group.add_argument("--unkpen", default=0, type=float, help="unknown word penalty")
    group.add_argument("--replace-unk", nargs="?", const=True, default=None)
    group.add_argument("--sacrebleu", action="store_true", help="score with sacrebleu")
    group.add_argument("--score-reference", action="store_true", help="just score the reference translation")
    group.add_argument("--prefix-size", default=0, type=int, metavar="PS",
                       help="initialize generation by target prefix of given length")
    group.add_argument("--no-repeat-ngram-size", default=0, type=int, metavar="N",
                       help="ngram blocking such that this size ngram cannot be repeated")
    group.add_argument("--sampling", action="store_true", help="sample hypotheses instead of using beam search")
    group.add_argument("--sampling-topk", default=-1, type=int, metavar="PS",
                       help="sample from top K likely next words")
    group.add_argument("--sampling-topp", default=-1.0, type=float, metavar="PS",
                       help="sample from the smallest set of words whose cumulative probability mass exceeds p")
    group.add_argument("--temperature", default=1.0, type=float, metavar="N", help="temperature for generation")
    group.add_argument("--diverse-beam-groups", default=-1, type=int, metavar="N")
    group.add_argument("--diverse-beam-strength", default=0.5, type=float, metavar="N")
    group.add_argument("--diversity-rate", default=-1.0, type=float, metavar="N")
    group.add_argument("--print-alignment", action="store_true")
    # the iterative refinement generator's flags (NOT_PORTED)
    group.add_argument("--decoding-format", default=None, type=str, choices=["unigram", "ensemble", "vote", "dp", "bs"])
    group.add_argument("--iter-decode-eos-penalty", default=0.0, type=float, metavar="N")
    group.add_argument("--iter-decode-max-iter", default=10, type=int, metavar="N")
    group.add_argument("--iter-decode-force-max-iter", action="store_true")
    group.add_argument("--iter-decode-with-beam", default=1, type=int, metavar="N")
    group.add_argument("--iter-decode-with-external-reranker", action="store_true")
    group.add_argument("--retain-iter-history", action="store_true")
    group.add_argument("--print-step", action="store_true")
    return group


def add_interactive_args(parser):
    group = parser.add_argument_group("Interactive")
    group.add_argument("--buffer-size", default=0, type=int, metavar="N",
                       help="read this many sentences into a buffer before processing them")
    group.add_argument("--input", default="-", type=str, metavar="FILE", help="file to read from; - for stdin")
    return group


def check_ported(args: argparse.Namespace) -> None:
    """Raise ``NotImplementedError`` for a set option the port lacks."""
    for name, (off, what) in NOT_PORTED.items():
        value = getattr(args, name, off)
        if value != off:
            raise NotImplementedError(f"--{name.replace('_', '-')}: {what} is not ported")


def parse_args_and_arch(parser: argparse.ArgumentParser, input_args: Optional[List[str]] = None,
                        parse_known: bool = False):
    """The two-pass parse (reference options.py:81-196): the arch's, the
    task's, the criterion's (and its underlying criterion's), the
    optimiser's and the scheduler's flags join the parser, then the arch
    preset's defaults the namespace (``registry.apply_architecture``).
    ``--user-dir`` is imported first, so that what it registers is there;
    the ``--tokenizer`` / ``--bpe`` codecs add their flags as in JAX."""
    usr_parser = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    usr_parser.add_argument("--user-dir", default=None)
    import_user_module(usr_parser.parse_known_args(input_args)[0])
    args, _ = parser.parse_known_args(input_args)
    tolerant = _TolerantParser(parser)
    for reg, attr in ((registry.TASKS, "task"), (registry.CRITERIONS, "criterion"), (OPTIMIZERS, "optimizer"),
                      (LR_SCHEDULERS, "lr_scheduler"), (registry.TOKENIZERS, "tokenizer"), (registry.BPES, "bpe")):
        name = getattr(args, attr, None)
        if name is not None and name in reg:
            cls = reg[name]
            if hasattr(cls, "add_args"):
                cls.add_args(tolerant)
    args2, _ = parser.parse_known_args(input_args)
    underlying = getattr(args2, "underlying_criterion", None)
    if underlying and underlying in registry.CRITERIONS:
        registry.CRITERIONS.add_args(underlying, _TolerantParser(
            parser.add_argument_group("Underlying criterion configuration", argument_default=argparse.SUPPRESS)))
    if getattr(args, "arch", None) in ARCHITECTURES:
        _add_arch_args(parser, args.arch)
    if parse_known:
        args, extra = parser.parse_known_args(input_args)
    else:
        args, extra = parser.parse_args(input_args), None
    check_ported(args)
    if getattr(args, "arch", None) is not None:
        registry.apply_architecture(args)
    if getattr(args, "no_pallas_attention", False) or getattr(args, "use_pallas_attention", False):
        from .ops.attention import set_flash_attention

        set_flash_attention(not getattr(args, "no_pallas_attention", False))
    return (args, extra) if parse_known else args


class _TolerantParser:
    """Adds arguments, skipping a flag the parser already has (a model's
    and a criterion's ``--ctc-encoder-layer``, the optimisers'
    ``--weight-decay``)."""

    def __init__(self, parser):
        self._parser = parser

    def add_argument(self, *a, **k):
        try:
            return self._parser.add_argument(*a, **k)
        except argparse.ArgumentError:
            return None

    def __getattr__(self, name):
        return getattr(self._parser, name)
