"""PyTorch port, multi-GPU slice: data parallelism with synced BatchNorm,
update_freq and FSDP over gloo processes on the CPU, against JAX's
Trainer on the global batch.

JAX's sharded steps compute its unsharded step on the global batch (its
own mesh tests, tests/test_fsdp.py, tests/test_dp_trajectory.py, assert
that), so the JAX side runs unsharded, jitted, once for the file. The port
runs two gloo ranks (``tests/torch_dist.py``, one spawn for every scenario
of the file); each rank collates the same global batch and takes its rows.
Dropout is the identity on both sides (the conv front end's floor of 0.1
cannot be turned off otherwise), and the criterion runs in training mode,
so the BatchNorm statistics are the global batch's: the step differs from
JAX's without the synced statistics. fp32; the tolerances are stated per
test."""

import re
import sys

import jax
import numpy as np
import pytest

from fbk_fairseq_st_tpu import options as joptions
from fbk_fairseq_st_tpu import registry
from fbk_fairseq_st_tpu.ops import core as jcore
from fbk_fairseq_st_tpu.train.trainer import Trainer as JaxTrainer
from fbk_fairseq_st_tpu_torch.utils.weights import state_dict_from_jax

from .test_torch_model import SMALL, VOCAB
from .torch_dist import start_ranks
from .torch_shared import session_root, shared
from .utils import DummyTask, dummy_dictionary

SRC_VOCAB = 12
ROWS = 8
FEATS = SMALL["input_feat_per_channel"]
COMMON = [
    "--optimizer", "adam", "--adam-betas", "(0.9, 0.98)", "--weight-decay", "0.0001",
    "--lr", "0.002", "--lr-scheduler", "inverse_sqrt", "--warmup-updates", "2",
    "--clip-norm", "10.0", "--max-tokens", "4000", "--dropout", "0", "--attention-dropout", "0",
    "--relu-dropout", "0",
] + [f"--{k.replace('_', '-')}={v}" for k, v in SMALL.items()]
LSCE_ARGV = ["/nonexistent", "--task", "speech_recognition", "-t", "de", "--arch", "conv_transformer",
             "--criterion", "label_smoothed_cross_entropy", "--label-smoothing", "0.1"] + COMMON
CTC_ARGV = ["/nonexistent", "--task", "speech_translation_with_transcription", "-s", "en", "-t", "de",
            "--arch", "conv_transformer", "--criterion", "ctc_multi_loss",
            "--underlying-criterion", "label_smoothed_cross_entropy", "--label-smoothing", "0.1",
            "--ctc-encoder-layer", "1", "--ctc-weight", "0.5", "--ctc-compress-out"] + COMMON
FSDP_MIN = 256
# leaves whose exact gradient is 0, and the running means they shift: a key
# projection's bias moves every score of a row alike, and ConvAttention2D's
# projections feed BatchNorms, which take the mean off; each side's Adam
# turns its own rounding noise there into steps of up to lr
ZERO_GRADIENT = re.compile(r".*(k_proj\.bias|attn_2d\.\d+\.(in_proj_bias|out_proj\.bias|bn_\w+\.running_mean))$")


def global_batch(seed, real, rows=ROWS, t=37, tgt_len=8, transcripts=False):
    """A collated global batch of ``rows`` rows as the shape buckets make
    one: ``real`` utterances, then padding rows of length 0."""
    rng = np.random.RandomState(seed)
    lengths = np.zeros(rows, np.int64)
    lengths[:real] = rng.randint(t - 15, t + 1, size=real)
    lengths[0] = t
    src = np.zeros((rows, t, FEATS), np.float32)
    for i in range(real):
        src[i, :lengths[i]] = rng.randn(lengths[i], FEATS)
    tokens = np.ones((rows, tgt_len), np.int64)
    tokens[:real] = rng.randint(4, VOCAB + 4, size=(real, tgt_len))
    tokens[real - 1, -2:] = 1
    prev = np.ones_like(tokens)
    prev[:real, 0] = 2
    prev[:real, 1:] = tokens[:real, :-1]
    sample = {"net_input": {"src_tokens": src, "src_lengths": lengths, "prev_output_tokens": prev},
              "target": tokens, "ntokens": int((tokens != 1).sum()), "nsentences": real}
    if transcripts:
        tr = np.ones((rows, 6), np.int64)
        tr_len = np.zeros(rows, np.int64)
        for i in range(real):
            tr_len[i] = rng.randint(2, 6)
            tr[i, :tr_len[i]] = rng.randint(4, 4 + SRC_VOCAB, size=tr_len[i])
        tr_prev = np.ones_like(tr)
        tr_prev[:real, 0] = 2
        tr_prev[:real, 1:] = tr[:real, :-1]
        sample["net_input"]["transcript_prev_output_tokens"] = tr_prev
        sample["transcript_target"] = tr
        sample["transcript_target_lengths"] = tr_len
    return sample


def _identity_dropout(x, *args, **kwargs):
    return x


class JaxRun:
    """JAX's Trainer, built unsharded; ``start`` holds its initial weights in
    the port's state-dict names. Build and step it inside ``no_jax_dropout``."""

    def __init__(self, argv, src_vocab=None):
        # one device: the unsharded step
        args = joptions.parse_args_and_arch(joptions.get_training_parser(),
                                            list(argv) + ["--distributed-world-size", "1"])
        jsd = None
        if src_vocab is not None:
            jsd = dummy_dictionary(src_vocab)
            jsd.add_symbol("<ctc_blank>")
        jtask = DummyTask(dummy_dictionary(VOCAB), jsd)
        jmodel = registry.build_model(args, jtask)
        jmodel.init = jax.jit(jmodel.init)  # an eager init takes seconds on the CPU
        self.trainer = JaxTrainer(args, jtask, jmodel, registry.CRITERIONS[args.criterion].build_criterion(args, jtask))
        self.gnorms = []
        log_training = self.trainer._log_training
        self.trainer._log_training = lambda lo, gnorm, meta: (self.gnorms.append(gnorm),
                                                             log_training(lo, gnorm, meta))
        self.start = self.weights()

    def weights(self):
        sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, self.trainer.variables()))
        return {k: v.numpy() for k, v in sd.items()}

    def run(self, updates):
        """Per update its logging outputs and gnorm, then the weights."""
        logs, lr_sum = [], 0.0
        for step, samples in enumerate(updates):
            lr_sum += self.trainer.lr_scheduler.step_update(step)
            logs.append(dict(self.trainer.train_step(samples), gnorm=float(self.gnorms[step])))
        return dict(start=self.start, logs=logs, after=self.weights(), lr_sum=lr_sum)


def no_jax_dropout(mp) -> None:
    """Every dropout of the JAX package the identity (its modules must be
    imported: ``registry.build_model`` imports them)."""
    from fbk_fairseq_st_tpu.models import conv_transformer  # noqa: F401

    original = jcore.dropout
    for mod in list(sys.modules.values()):
        if getattr(mod, "__name__", "").startswith("fbk_fairseq_st_tpu.") and getattr(mod, "dropout", None) is original:
            mp.setattr(mod, "dropout", _identity_dropout)


LSCE_UPDATES = [[global_batch(0, 8)], [global_batch(1, 5)], [global_batch(2, 6)]]
CTC_UPDATES = [[global_batch(10 * s + i, 3 + i, rows=4, transcripts=True) for i in range(2)] for s in range(3)]


def jax_lsce(directory=None):
    """JAX's three label-smoothed CE updates on ``LSCE_UPDATES`` (shared by
    the session's multi-GPU test files)."""
    with pytest.MonkeyPatch.context() as mp:
        no_jax_dropout(mp)
        return JaxRun(LSCE_ARGV).run(LSCE_UPDATES)


def _make(directory, lsce):
    """JAX's ctc_multi_loss run, and the port's ranks started as soon as
    JAX's start weights are there, so that both run at once."""
    fsdp = ["--fsdp", "--fsdp-min-shard-size", str(FSDP_MIN)]
    with pytest.MonkeyPatch.context() as mp:
        no_jax_dropout(mp)
        ctc = JaxRun(CTC_ARGV, src_vocab=SRC_VOCAB)
        wait = start_ranks(2, [
            ("dp", dict(fn="train", argv=LSCE_ARGV, vocab=VOCAB, init_state=lsce["start"], updates=LSCE_UPDATES)),
            ("fsdp", dict(fn="train", argv=LSCE_ARGV, vocab=VOCAB, init_state=lsce["start"], updates=LSCE_UPDATES,
                          argv_extra=fsdp, resume_at=2)),
            ("ctc", dict(fn="train", argv=CTC_ARGV, vocab=VOCAB, init_state=ctc.start, updates=CTC_UPDATES,
                         src_vocab=SRC_VOCAB)),
        ], directory)
        out = dict(lsce=lsce, ctc=ctc.run(CTC_UPDATES))
    out["ranks"] = wait()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = session_root(tmp_path_factory)
    lsce = shared(root, "torch_dist_jax_lsce", jax_lsce)
    return shared(root, "torch_distributed", lambda directory: _make(directory, lsce))


def assert_matches(got_logs, got_state, want, keys=("loss", "nll_loss", "ntokens", "nsentences", "sample_size")):
    """Per update the logging outputs and the gnorm at rtol 1e-5; then
    every parameter and BatchNorm buffer within 1e-5 x max(1, its largest
    entry), the single-device tests' atol 1e-5 for the entries below 1
    (``ZERO_GRADIENT`` within 2 x the summed lr, as the key-projection
    biases in tests/test_torch_train.py)."""
    assert len(got_logs) == len(want["logs"])
    for step, (got, exp) in enumerate(zip(got_logs, want["logs"])):
        for key in keys + ("gnorm",):
            np.testing.assert_allclose(got[key], exp[key], rtol=1e-5, err_msg=f"{key} update {step}")
    assert sorted(got_state) == sorted(want["after"])
    bad = {}
    for name, value in want["after"].items():
        tol = 2 * want["lr_sum"] if ZERO_GRADIENT.match(name) else 1e-5 * max(np.abs(value).max(), 1.0)
        err = np.abs(got_state[name] - value).max()
        if err > tol:
            bad[name] = (float(err), tol)
    assert not bad, bad


def test_data_parallel_steps_match_jax(runs):
    """Three updates at world size 2 (label-smoothed CE; global batches of
    8 rows with 8, 5 and 6 utterances, so the second rank holds 4 padding
    rows of 4, then 1 and 2 utterances) equal JAX's unsharded steps: the
    loss, the counts, the gnorm, every parameter and the BatchNorm running
    stats. Both ranks log the same values."""
    dp = runs["ranks"]["dp"]
    assert dp[0]["logs"] == dp[1]["logs"]
    assert_matches(dp[0]["logs"], dp[0]["state"], runs["lsce"])
    bn = runs["lsce"]["after"]["encoder.bn.0.running_mean"]
    assert not np.array_equal(bn, runs["lsce"]["start"]["encoder.bn.0.running_mean"])


def test_ctc_multi_loss_update_freq_2_matches_jax(runs):
    """Three updates of two microbatches each (``ctc_multi_loss`` with CTC
    compression after layer 1; 3 and 4 utterances in 4 rows) at world size
    2 equal JAX's: the sample size divided by is the global sum over the
    microbatches and the ranks of the returned (transcript) sizes."""
    ctc = runs["ranks"]["ctc"]
    assert_matches(ctc[0]["logs"], ctc[0]["state"], runs["ctc"],
                   keys=("loss", "nll_loss", "ctc_loss", "ntokens", "nsentences", "sample_size", "ctc_errors",
                         "ctc_total"))


def test_fsdp_step_equals_data_parallel_and_shrinks_the_state(runs):
    """--fsdp at world size 2 (leaves of at least 256 elements in chunks):
    the same steps as JAX's, resumed after the second update from the
    trainer's whole state into a new trainer with the same layout; each
    rank's parameter and Adam-state bytes are the replicated ones less half
    of every chunked leaf's."""
    fsdp, dp = runs["ranks"]["fsdp"], runs["ranks"]["dp"]
    assert_matches(fsdp[0]["logs"], fsdp[0]["state"], runs["lsce"])
    layout = fsdp[0]["layout"]
    whole = {k: v.shape for k, v in runs["lsce"]["start"].items()}
    split = {name for name, spec in layout.items() if "data" in spec}
    assert split and all(np.prod(whole[n]) >= FSDP_MIN for n in split)
    assert all(np.prod(whole[n]) < FSDP_MIN or np.all([s % 2 for s in whole[n]]) for n in whole
               if n not in split and n in dp[0]["shapes"])
    half = sum(4 * np.prod(whole[n]) // 2 for n in split)
    for rank in range(2):
        assert fsdp[rank]["param_bytes"] == dp[rank]["param_bytes"] - half
        assert fsdp[rank]["opt_bytes"] == dp[rank]["opt_bytes"] - 2 * half
        for n in split:
            owner, _, attr = n.rpartition(".")
            d = layout[n].index("data")
            assert fsdp[rank]["shapes"][f"{owner}.parametrizations.{attr}.original"][d] == whole[n][d] // 2
