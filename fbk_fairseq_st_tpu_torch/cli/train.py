"""Train CLI: the epoch loop, validation, checkpoints, early stopping and
resume.

Counterpart of ``fbk_fairseq_st_tpu/cli/train.py`` (``main`` :135,
``should_stop_early`` :266, ``train`` :282, ``validate_and_save`` :365,
``validate`` :410, ``cli_main`` :466; reference fairseq_cli/train.py): it
sets the task up from the command line, loads the splits, builds the model
on the card (on the CPU with ``--cpu`` only) and the trainer, restores
``checkpoint_last.pt`` (or ``--restore-file``: the port's own file, a JAX
pickle with its optimiser state, or a fork ``.pt``), then trains epoch by
epoch until ``--max-epoch``, ``--max-update``, ``--min-lr`` or
``--patience`` stops it. Each epoch walks the batch iterator through the
device prefetch (``--device-prefetch``) in groups of ``--update-freq``;
the trainer's outputs stay on the device until a ``--log-interval``
boundary, a validation or a save brings them over (``flush_logs``).
Validation runs at each epoch's end (every ``--validate-interval``) and
with every ``--save-interval-updates`` save; checkpoints follow JAX's names
and retention. SIGTERM and SIGINT finish the update in flight, save
``checkpoint_last.pt`` and stop; the iterator's position rides in the
checkpoint, so the resumed run goes on at the next batch. ``--profile``
writes a ``torch.profiler`` trace of the run to ``<save-dir>/profile``.

Several GPUs (JAX's ``distributed_init`` :83-133, the reference's
``distributed_utils.call_main``): ``--distributed-world-size N`` on one
host spawns N ranks, one a GPU, over NCCL (gloo with ``--cpu``), each
running ``main`` on its rank of one process group; more ranks than the
host has GPUs raise. Across hosts, each host's process is started with
``--distributed-init-method tcp://HOST:PORT`` (or
``--distributed-coordinator HOST:PORT``), ``--distributed-num-processes``,
``--distributed-process-id`` and ``--distributed-local-device-ids``, and
spawns a rank for each of its devices: a JAX process is a host, a rank
here a GPU, so the global rank is the process id x the local devices + the
local rank. A rendezvous address given alone makes a group of
``--distributed-world-size`` (1 by default) spawned ranks. Ranks other than
the first log warnings only and print no progress lines; the first writes
the checkpoints.

    python -m fbk_fairseq_st_tpu_torch.cli.train DATA --task speech_translation_with_transcription \\
        -s en -t de --arch conv_transformer --criterion ctc_multi_loss \\
        --underlying-criterion label_smoothed_cross_entropy --label-smoothing 0.1 \\
        --ctc-encoder-layer 4 --ctc-compress-out --optimizer adam --lr 0.002 \\
        --lr-scheduler inverse_sqrt --warmup-updates 4000 --max-tokens 25000 --bf16 --save-dir ckpts
"""

from __future__ import annotations

import datetime
import logging
import math
import os
import socket
import sys

import numpy as np
import torch

from .. import options
from ..criterions.base import get_perplexity
from ..data.iterators import DevicePrefetchIterator, GroupedIterator
from ..device import resolve_device
from ..quantization.quantizer import Quantizer
from ..registry import TASKS
from ..train import checkpoint as checkpoint_utils
from ..utils.user_dir import import_user_module
from ..train import metrics
from ..train.progress import progress_bar
from ..train.trainer import Trainer

logger = logging.getLogger("fbk_fairseq_st_tpu_torch.cli.train")

# the signal that asked the run to stop, set by the SIGTERM/SIGINT handler
# and read at update boundaries
_INTERRUPT = {"sig": None}


def _install_interrupt_handlers():
    """SIGTERM/SIGINT -> finish the update in flight, save, stop. Returns
    the handlers they replace (none off the main thread, where Python
    allows no signal handler)."""
    import signal
    import threading

    if threading.current_thread() is not threading.main_thread():
        return {}

    def _handler(sig, frame):
        _INTERRUPT["sig"] = sig
        logger.info("received signal %s: will checkpoint and exit at the next update boundary", sig)

    return {s: signal.signal(s, _handler) for s in (signal.SIGTERM, signal.SIGINT)}


def _restore_interrupt_handlers(previous) -> None:
    import signal

    for sig, handler in previous.items():
        signal.signal(sig, handler)


def main(args):
    if getattr(args, "max_tokens", None) is None and getattr(args, "max_sentences", None) is None:
        raise ValueError("Must specify batch size either with --max-tokens or --max-sentences")
    import_user_module(args)
    device = resolve_device("cpu" if args.cpu else None)
    np.random.seed(args.seed)
    checkpoint_utils.verify_checkpoint_directory(args.save_dir)

    # fresh global state per run (several runs may share a process)
    metrics.reset()
    checkpoint_utils._manager.best = None
    for attr in ("best", "num_runs"):
        if hasattr(should_stop_early, attr):
            delattr(should_stop_early, attr)

    task = TASKS[args.task].setup_task(args)
    if not getattr(args, "disable_validation", False):
        for valid_sub_split in args.valid_subset.split(","):
            task.load_dataset(valid_sub_split, combine=False, epoch=0)
    task.load_dataset(args.train_subset, combine=True, epoch=0)

    model = task.build_model(args, device=device)
    criterion = task.build_criterion(args)
    logger.info(f"model {args.arch}, criterion {criterion.__class__.__name__}")
    quantizer = None
    if getattr(args, "quantization_config_path", None):
        # in-training iterative PQ (reference fairseq_cli/train.py:81-94)
        quantizer = Quantizer(args.quantization_config_path, max_epoch=getattr(args, "max_epoch", 0) or 0,
                              max_update=getattr(args, "max_update", 0) or 0)
    trainer = Trainer(args, task, model, criterion, quantizer=quantizer)
    if quantizer is not None:
        quantizer.set_trainer(trainer)
    logger.info("num. model params: {}".format(sum(p.numel() for p in model.parameters())))
    logger.info("training on {}".format(torch.cuda.get_device_name(device) if device.type == "cuda" else "the CPU"))

    _, epoch_itr = checkpoint_utils.load_checkpoint(args, trainer, task)
    if quantizer is not None:
        # again after the restore: a quantised checkpoint's stages are done
        quantizer.set_trainer(trainer)
    lr = trainer.get_lr()
    max_epoch = args.max_epoch or math.inf
    max_update = args.max_update or math.inf

    profiler = None
    if getattr(args, "profile", False):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.__enter__()

    _INTERRUPT["sig"] = None
    prev_handlers = _install_interrupt_handlers() if getattr(args, "save_on_interrupt", True) else {}
    try:
        # the reference's loop test (fairseq_cli/train.py): a run restored
        # mid-way through its last epoch finishes it; JAX's
        # ``epoch_itr.epoch < max_epoch`` stops there (ROADMAP Queue C)
        while lr > args.min_lr and epoch_itr.next_epoch_idx <= max_epoch and trainer.get_num_updates() < max_update:
            valid_losses = train(args, trainer, task, epoch_itr, max_update)
            if _INTERRUPT["sig"] is not None:
                logger.info("exiting cleanly on signal %s (checkpoint saved)", _INTERRUPT["sig"])
                break
            if should_stop_early(args, valid_losses[0]):
                logger.info(f"early stop since valid performance hasn't improved for last {args.patience} runs")
                break
            lr = trainer.lr_step(epoch_itr.epoch, valid_losses[0])
            if trainer.get_num_updates() >= max_update:
                break
    finally:
        _restore_interrupt_handlers(prev_handlers)
        if profiler is not None:
            profiler.__exit__(None, None, None)
            profile_dir = os.path.join(args.save_dir, "profile")
            os.makedirs(profile_dir, exist_ok=True)
            profiler.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
            logger.info("profiler trace written to {}".format(profile_dir))
    checkpoint_utils.wait_for_async_writes()
    logger.info("done training")
    return trainer, epoch_itr


def should_stop_early(args, valid_loss) -> bool:
    """--patience: stop after that many validations without a new best."""
    if valid_loss is None or getattr(args, "patience", -1) <= 0:
        return False

    def is_better(a, b):
        return a > b if args.maximize_best_checkpoint_metric else a < b

    prev_best = getattr(should_stop_early, "best", None)
    if prev_best is None or is_better(valid_loss, prev_best):
        should_stop_early.best = valid_loss
        should_stop_early.num_runs = 0
        return False
    should_stop_early.num_runs = getattr(should_stop_early, "num_runs", 0) + 1
    return should_stop_early.num_runs >= args.patience


def _flush(trainer) -> None:
    """The trainer's pending outputs into the metrics stack, counted in the
    ``train_inner`` meters too (where JAX's per-update sync logs them)."""
    with metrics.aggregate("train_inner"):
        trainer.flush_logs()


def train(args, trainer, task, epoch_itr, max_update):
    """One epoch (reference fairseq_cli/train.py:157-212)."""
    itr = epoch_itr.next_epoch_itr(shuffle=(epoch_itr.epoch > args.curriculum))
    if trainer.quantizer is not None:
        # the epoch-scheduled iPQ stage boundaries (reference trainer.py:328)
        trainer.quantizer.begin_epoch(epoch_itr.epoch)
    update_freq = (args.update_freq[epoch_itr.epoch - 1] if epoch_itr.epoch <= len(args.update_freq)
                   else args.update_freq[-1])
    if getattr(args, "device_prefetch", 2) > 0:
        itr = DevicePrefetchIterator(itr, trainer.stage_sample, lookahead=args.device_prefetch)
    itr = GroupedIterator(itr, update_freq)
    progress = progress_bar(itr, log_format=args.log_format, log_interval=args.log_interval, epoch=epoch_itr.epoch,
                            tensorboard_logdir=getattr(args, "tensorboard_logdir", None), default_log_format="simple")

    valid_subsets = args.valid_subset.split(",")
    valid_losses = [None]
    with metrics.aggregate("train"):
        for samples in progress:
            prev_updates = trainer.get_num_updates()
            with metrics.aggregate("train_inner"):
                log_output = trainer.train_step(samples)
                if log_output is None:
                    continue
                num_updates = trainer.get_num_updates()
                if num_updates // args.log_interval > prev_updates // args.log_interval:
                    trainer.flush_logs()
            if num_updates // args.log_interval > prev_updates // args.log_interval:
                stats = get_training_stats(metrics.get_smoothed_values("train_inner"))
                progress.log(stats, tag="train_inner", step=num_updates)
                metrics.reset_meters("train_inner")

            valid_losses = validate_and_save(args, trainer, task, epoch_itr, valid_subsets, end_of_epoch=False,
                                             prev_updates=prev_updates)
            if _INTERRUPT["sig"] is not None:
                # stop now: checkpoint without validating (the grace window
                # is short); the iterator's position rides in it
                _flush(trainer)
                checkpoint_utils.save_checkpoint(args, trainer, epoch_itr, None)
                return valid_losses
            if trainer.get_num_updates() >= max_update:
                break
        _flush(trainer)

    valid_losses = validate_and_save(args, trainer, task, epoch_itr, valid_subsets, end_of_epoch=True)
    stats = get_training_stats(metrics.get_smoothed_values("train"))
    progress.print(stats, tag="train", step=trainer.get_num_updates())
    metrics.reset_meters("train")
    return valid_losses


def validate_and_save(args, trainer, task, epoch_itr, valid_subsets, end_of_epoch, prev_updates=None):
    """Reference fairseq_cli/train.py:214-253: save at an epoch's end every
    ``--save-interval`` epochs and whenever the update count crosses a
    multiple of ``--save-interval-updates``; validate with every save inside
    an epoch and at an epoch's end every ``--validate-interval`` epochs."""
    num_updates = trainer.get_num_updates()
    si = args.save_interval_updates
    crossed_save = si > 0 and num_updates > 0 and (
        num_updates % si == 0 if prev_updates is None else num_updates // si > prev_updates // si)
    do_save = (end_of_epoch and epoch_itr.epoch % args.save_interval == 0) or crossed_save
    do_validate = (((not end_of_epoch and do_save) or (end_of_epoch and epoch_itr.epoch % args.validate_interval == 0))
                   and not getattr(args, "disable_validation", False))
    valid_losses = [None]
    if do_validate or do_save:
        # the NaN check runs in the flush: a checkpoint never holds the
        # weights of an update whose gradients were not finite
        _flush(trainer)
    if do_validate:
        valid_losses = validate(args, trainer, task, epoch_itr, valid_subsets)
    if do_save:
        checkpoint_utils.save_checkpoint(args, trainer, epoch_itr, valid_losses[0])
    return valid_losses


def validate(args, trainer, task, epoch_itr, subsets):
    """The criterion over each validation subset (reference
    fairseq_cli/train.py:255-294); returns the best-checkpoint metric of each."""
    valid_losses = []
    for subset in subsets:
        itr = task.get_batch_iterator(
            dataset=task.dataset(subset), max_tokens=getattr(args, "max_tokens_valid", None) or args.max_tokens,
            max_sentences=getattr(args, "max_sentences_valid", None) or args.max_sentences,
            max_positions=task.max_positions(), ignore_invalid_inputs=True,
            required_batch_size_multiple=args.required_batch_size_multiple, seed=args.seed,
            bucket_shapes=True).next_epoch_itr(shuffle=False)
        progress = progress_bar(itr, log_format=args.log_format, log_interval=args.log_interval,
                                epoch=epoch_itr.epoch, prefix=f"valid on '{subset}' subset",
                                tensorboard_logdir=getattr(args, "tensorboard_logdir", None),
                                default_log_format="simple")
        with metrics.aggregate(new_root=True) as agg:
            for sample in progress:
                trainer.valid_step(sample)
        stats = get_valid_stats(args, trainer, agg.get_smoothed_values())
        progress.print(stats, tag=subset, step=trainer.get_num_updates())
        valid_losses.append(stats[args.best_checkpoint_metric])
    return valid_losses


def get_training_stats(stats):
    if "nll_loss" in stats and "ppl" not in stats:
        stats["ppl"] = get_perplexity(stats["nll_loss"])
    stats["wall"] = round(metrics.get_meter("default", "wall").elapsed_time, 0)
    return stats


def get_valid_stats(args, trainer, stats):
    if "nll_loss" in stats and "ppl" not in stats:
        stats["ppl"] = get_perplexity(stats["nll_loss"])
    stats["num_updates"] = trainer.get_num_updates()
    key = "best_" + args.best_checkpoint_metric
    if checkpoint_utils._manager.best is not None:
        best_function = max if args.maximize_best_checkpoint_metric else min
        stats[key] = best_function(checkpoint_utils._manager.best, stats[args.best_checkpoint_metric])
    return stats


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


class Launch:
    """The rendezvous and this host's share of a multi-GPU run."""

    def __init__(self, args):
        coord = getattr(args, "distributed_coordinator", None)
        init = getattr(args, "distributed_init_method", None)
        nproc = getattr(args, "distributed_num_processes", None)
        world = getattr(args, "distributed_world_size", None)
        port = getattr(args, "distributed_port", -1) or -1
        if coord is not None:
            init = "tcp://" + coord
        elif init is not None and "://" not in init:
            init = "tcp://" + init
        if init is not None and not init.startswith(("tcp://", "file://")):
            raise ValueError(f"--distributed-init-method takes tcp://HOST:PORT or file://PATH, got {init!r}")
        if nproc is not None and nproc > 1 and init is None:
            raise ValueError("--distributed-num-processes > 1 needs --distributed-init-method or "
                             "--distributed-coordinator: the hosts' rendezvous")
        self.num_processes = nproc or 1
        self.process_id = getattr(args, "distributed_process_id", None) or 0
        ids = getattr(args, "distributed_local_device_ids", None)
        if ids:
            self.local_devices = [int(x) for x in str(ids).split(",")]
        else:
            per_host = (world or 1) // self.num_processes
            if per_host * self.num_processes != (world or 1):
                raise ValueError(f"--distributed-world-size {world} does not split over "
                                 f"{self.num_processes} processes")
            self.local_devices = list(range(per_host))
        self.world_size = self.num_processes * len(self.local_devices)
        if world is not None and world != self.world_size:
            raise ValueError(f"--distributed-world-size {world}, but {self.num_processes} processes x "
                             f"{len(self.local_devices)} local devices make {self.world_size} ranks")
        if init is None and port > 0:
            init = f"tcp://localhost:{port}"
        if init is None and self.world_size > 1:
            init = f"tcp://localhost:{_free_port()}"
        self.init_method = init
        self.cpu = bool(getattr(args, "cpu", False))
        backend = getattr(args, "distributed_backend", "pjit")
        self.backend = ("gloo" if self.cpu else "nccl") if backend in (None, "pjit") else backend
        if self.cpu and self.backend == "nccl":
            raise ValueError("--distributed-backend nccl needs the GPUs: drop --cpu")

    @property
    def distributed(self) -> bool:
        return self.init_method is not None

    def check_devices(self) -> None:
        """More ranks on this host than it has GPUs raise: no rank runs on
        the CPU in their place."""
        if self.cpu:
            return
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if len(self.local_devices) > have or max(self.local_devices) >= have:
            raise RuntimeError(f"{len(self.local_devices)} ranks on this host (devices {self.local_devices}), "
                               f"which has {have} CUDA devices: lower --distributed-world-size, or pass --cpu")


def distributed_main(local_rank: int, args, launch: Launch, timeout_s: float = 1800.0):
    """One rank: join the process group, run ``main``, leave the group."""
    _configure_logging()  # a spawned process starts with none
    rank = launch.process_id * len(launch.local_devices) + local_rank
    if not launch.cpu:
        torch.cuda.set_device(launch.local_devices[local_rank])
    torch.distributed.init_process_group(launch.backend, init_method=launch.init_method,
                                         world_size=launch.world_size, rank=rank,
                                         timeout=datetime.timedelta(seconds=timeout_s))
    # JAX :123-126, reference distributed_utils.py:105-108: the other ranks
    # log warnings only (the level set here: a handler that an import put
    # on the root logger makes basicConfig a no-op)
    logging.getLogger().setLevel(logging.INFO if rank == 0 else logging.WARNING)
    if rank != 0:
        args.log_format = "none"
        args.tensorboard_logdir = None
    logger.info("rank %d of %d (%s, %s)", rank, launch.world_size, launch.backend, launch.init_method)
    try:
        return main(args)
    finally:
        torch.distributed.destroy_process_group()


def call_main(args):
    """``main`` in this process, or on the ranks of a multi-GPU run."""
    launch = Launch(args)
    if not launch.distributed:
        return main(args)
    launch.check_devices()
    if getattr(args, "distributed_no_spawn", False):
        return distributed_main(getattr(args, "device_id", 0), args, launch)
    import torch.multiprocessing as mp

    mp.spawn(distributed_main, args=(args, launch), nprocs=len(launch.local_devices), join=True)
    return None


def _configure_logging() -> None:
    logging.basicConfig(format="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
                        datefmt="%Y-%m-%d %H:%M:%S", level=logging.INFO, stream=sys.stdout)


def cli_main(input_args=None):
    _configure_logging()
    parser = options.get_training_parser()
    args = options.parse_args_and_arch(parser, input_args)
    return call_main(args)


if __name__ == "__main__":
    cli_main()
