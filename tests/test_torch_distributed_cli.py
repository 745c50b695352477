"""PyTorch port, multi-GPU slice: ``cli/train --cpu --distributed-world-size
2`` against the same command at world size 1, on a tiny speech-translation
corpus written by the port's own ``preprocess_audio`` / ``preprocess``.

The two-rank runs are separate processes (``python -m ...cli.train``, which
spawns its ranks over gloo), each with a deadline: past it the test kills
the process group and fails. Dropout: the criterion comes from a
``--user-dir`` module that runs the model in eval mode (the conv front
end's dropout has a floor of 0.1 that no flag lowers, and two ranks draw
other bits than one process), so a run's result is its data's alone.
No JAX here: the port's world-size-1 CLI is held against JAX's by
tests/test_torch_train_cli.py."""

import json
import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from fbk_fairseq_st_tpu_torch.cli import preprocess as tpreprocess
from fbk_fairseq_st_tpu_torch.cli import preprocess_audio as tpreprocess_audio
from fbk_fairseq_st_tpu_torch.cli import train as ttrain
from fbk_fairseq_st_tpu_torch.train import checkpoint as tcheckpoint

from .torch_dist import free_port
from .torch_shared import session_root, shared

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_MELS = 8
SPLITS = {"train": 16, "valid": 8}
DEADLINE = 120
USER_DIR = '''
from fbk_fairseq_st_tpu_torch.criterions import CRITERIONS, LabelSmoothedCrossEntropyCriterion


class EvalModeLabelSmoothedCrossEntropy(LabelSmoothedCrossEntropyCriterion):
    def __call__(self, model, batch, generator=None, training=False):
        return super().__call__(model, batch, generator, training=False)


CRITERIONS["label_smoothed_cross_entropy_eval"] = EvalModeLabelSmoothedCrossEntropy
'''


def write_corpus(data_dir, rng):
    """33-46-frame utterances (one source bucket), 2-6 target and
    transcript tokens, through the port's preprocessing CLIs."""
    os.makedirs(data_dir, exist_ok=True)
    for split, n in SPLITS.items():
        raw = os.path.join(data_dir, f"{split}_raw.npz")
        feats = [rng.randn(rng.randint(33, 47), N_MELS).astype(np.float32) for _ in range(n)]
        with open(raw, "wb") as f:
            np.save(f, np.array([len(feats)]))
            for feat in feats:
                np.save(f, feat)
        tpreprocess_audio.cli_main(["--audio-features", raw, "--format", "npz",
                                    "--output", os.path.join(data_dir, f"{split}.npz")])
        for lang, vocab in (("de", 12), ("en", 9)):
            with open(os.path.join(data_dir, f"{split}_raw.{lang}"), "w") as f:
                for _ in range(n):
                    f.write(" ".join(f"{lang}{rng.randint(vocab)}" for _ in range(rng.randint(2, 7))) + "\n")
    for lang in ("de", "en"):
        prefix = os.path.join(data_dir, "{}_raw")
        tpreprocess.cli_main(["--target-lang", lang, "--trainpref", prefix.format("train"),
                              "--validpref", prefix.format("valid"), "--destdir", data_dir, "--dataset-impl", "cached"])


def write_user_dir(root):
    user_dir = os.path.join(root, "fbk_dist_eval_criterion")
    os.makedirs(user_dir)
    with open(os.path.join(user_dir, "__init__.py"), "w") as f:
        f.write(USER_DIR)


def argv(root, save_dir, *extra):
    return [os.path.join(root, "data"), "--task", "speech_translation_with_transcription", "-s", "en", "-t", "de",
            "--arch", "conv_transformer", "--encoder-layers", "2", "--decoder-layers", "1",
            "--encoder-embed-dim", "16", "--decoder-embed-dim", "16", "--encoder-ffn-embed-dim", "32",
            "--decoder-ffn-embed-dim", "32", "--encoder-attention-heads", "2", "--decoder-attention-heads", "2",
            "--encoder-convolutions", "[(4, 3, 3)] * 2", "--input-feat-per-channel", str(N_MELS),
            "--max-source-positions", "64", "--max-target-positions", "32", "--dropout", "0",
            "--user-dir", os.path.join(root, "fbk_dist_eval_criterion"),
            "--criterion", "label_smoothed_cross_entropy_eval", "--label-smoothing", "0.1", "--optimizer", "adam",
            "--lr", "0.002", "--lr-scheduler", "inverse_sqrt", "--warmup-updates", "2", "--clip-norm", "10",
            "--max-sentences", "4", "--log-format", "json", "--log-interval", "1", "--save-dir", save_dir,
            "--seed", "3", "--cpu", *extra]


def in_process(args):
    ttrain.cli_main(args)


def launched(*argvs):
    """Each argv a ``cli/train`` process of its own (it spawns its ranks);
    their stdouts, within one deadline, past which every process group is
    killed."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME=os.environ.get("GLOO_SOCKET_IFNAME", "lo"))
    procs = [subprocess.Popen([sys.executable, "-m", "fbk_fairseq_st_tpu_torch.cli.train", *a], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, start_new_session=True)
             for a in argvs]
    end = time.monotonic() + DEADLINE
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=max(end - time.monotonic(), 0.1))[0])
    except subprocess.TimeoutExpired:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
        raise AssertionError(f"cli/train passed its {DEADLINE}-s deadline: {[p.communicate()[0][-2000:] for p in procs]}")
    for proc, out in zip(procs, outs):
        assert proc.returncode == 0, out[-4000:]
    return outs


def two_ranks(args):
    """``cli/train`` at world size 2 on this host: its stdout."""
    return launched([*args, "--distributed-world-size", "2"])[0]


def two_hosts(args):
    """``cli/train`` as two host processes of one rank each (the multi-host
    flags; the rendezvous a localhost port): their stdouts."""
    init = f"tcp://127.0.0.1:{free_port()}"
    return launched(*[[*args, "--distributed-init-method", init, "--distributed-num-processes", "2",
                       "--distributed-process-id", str(i), "--distributed-local-device-ids", "0"] for i in range(2)])


def params(save_dir):
    return tcheckpoint.load_checkpoint_to_cpu(os.path.join(save_dir, "checkpoint_last.pt"))


def assert_same(got, want, updates):
    """Every parameter and buffer at atol 1e-5; the attention key biases
    (gradient 0 up to rounding, which Adam scales to a step of up to lr)
    within updates x lr."""
    assert sorted(got["model"]) == sorted(want["model"])
    for k, v in want["model"].items():
        atol = updates * 0.002 if k.endswith("k_proj.bias") else 1e-5
        np.testing.assert_allclose(got["model"][k].numpy(), v.numpy(), rtol=0, atol=atol, err_msg=k)


def _make(root):
    """World size 1 and 2 to update 3; then the world-size-2 run resumed at
    world size 1 and at 2 (as two hosts of one rank each), each to update
    6."""
    write_corpus(os.path.join(root, "data"), np.random.RandomState(0))
    write_user_dir(root)
    dirs = {name: os.path.join(root, name) for name in ("one", "two", "two_then_one", "two_then_two")}
    in_process(argv(root, dirs["one"], "--max-update", "3"))
    out_two = two_ranks(argv(root, dirs["two"], "--max-update", "3"))
    for name in ("two_then_one", "two_then_two"):
        shutil.copytree(dirs["two"], dirs[name])
    in_process(argv(root, dirs["two_then_one"], "--max-update", "6"))
    out_resumed = two_hosts(argv(root, dirs["two_then_two"], "--max-update", "6"))
    return dirs, out_two, out_resumed


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return shared(session_root(tmp_path_factory), "torch_distributed_cli", _make)


def test_two_ranks_write_one_checkpoint_set_equal_to_one_rank(runs):
    """The world-size-2 run writes the same files as the world-size-1 run
    (once: the first rank writes), with the same weights."""
    dirs, _, _ = runs
    assert sorted(os.listdir(dirs["two"])) == sorted(os.listdir(dirs["one"]))
    assert "checkpoint_last.pt" in os.listdir(dirs["two"])
    got, want = params(dirs["two"]), params(dirs["one"])
    assert_same(got, want, updates=3)
    assert got["optimizer_history"][-1]["num_updates"] == want["optimizer_history"][-1]["num_updates"] == 3


def test_resume_at_world_size_one_and_two(runs):
    """The world-size-2 checkpoint resumes at world size 1 and at 2, the
    latter launched as two hosts (``--distributed-num-processes 2``, a
    process id each, global rank = process id x local devices + local
    rank); both reach update 6 with the same weights."""
    dirs, _, _ = runs
    one, two = params(dirs["two_then_one"]), params(dirs["two_then_two"])
    assert one["optimizer_history"][-1]["num_updates"] == two["optimizer_history"][-1]["num_updates"] == 6
    assert_same(two, one, updates=6)


def test_only_the_first_rank_prints_progress(runs):
    """One progress line per update (``--log-interval 1``): the second rank
    prints none (on one host, and as the second host's process)."""
    _, out_two, (out_resumed, second_host) = runs
    assert "train.progress" not in second_host and "rank 1 of 2" not in second_host
    for out, updates in ((out_two, (1, 2, 3)), (out_resumed, (4, 5, 6))):
        records = [json.loads(line.split(" | ")[-1]) for line in out.splitlines()
                   if "train.progress" in line and line.rstrip().endswith("}")]
        assert [int(r["num_updates"]) for r in records if "loss" in r] == list(updates), out[-3000:]
        assert out.count("rank 0 of 2") == 1 and "rank 1 of 2" not in out


def test_more_ranks_than_devices_raise(monkeypatch):
    """Asking for more ranks than the host has GPUs raises; nothing runs on
    the CPU in their place. The multi-host rank arithmetic: a host's ranks
    are its process id x its devices + the local rank."""
    from fbk_fairseq_st_tpu_torch import options

    def parse(*extra):
        return options.parse_args_and_arch(options.get_training_parser(), [
            "/nonexistent", "--task", "speech_recognition", "-t", "de", "--arch", "conv_transformer",
            "--max-tokens", "100", *extra])

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    launch = ttrain.Launch(parse("--distributed-world-size", "2"))
    assert launch.distributed and launch.backend == "nccl" and launch.world_size == 2
    with pytest.raises(RuntimeError, match="2 ranks on this host"):
        launch.check_devices()
    with pytest.raises(RuntimeError, match="2 ranks on this host"):
        ttrain.cli_main(["/nonexistent", "--task", "speech_recognition", "-t", "de", "--arch", "conv_transformer",
                         "--max-tokens", "100", "--distributed-world-size", "2"])
    hosts = ttrain.Launch(parse("--distributed-init-method", "tcp://10.0.0.1:29500", "--distributed-num-processes",
                                "2", "--distributed-process-id", "1", "--distributed-local-device-ids", "0"))
    assert (hosts.world_size, hosts.process_id, hosts.local_devices) == (2, 1, [0])
    assert hosts.init_method == "tcp://10.0.0.1:29500"
    assert not ttrain.Launch(parse()).distributed
    assert ttrain.Launch(parse("--cpu", "--distributed-world-size", "2")).backend == "gloo"
    with pytest.raises(ValueError, match="needs the GPUs"):
        ttrain.Launch(parse("--cpu", "--distributed-world-size", "2", "--distributed-backend", "nccl"))
