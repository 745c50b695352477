"""PyTorch port, ASG: the replabels (``data/replabels.py``), the ASG loss and
its Viterbi decode (``ops/asg.py``), the ``asg_loss`` criterion's host-side
packing, the ``w2l_conv_glu_enc`` model and whole ``asg_loss`` train steps
against the JAX package on the same numpy inputs, on the CPU.

JAX computes the loss and the decode with ``lax.scan`` outside any Pallas
kernel; the port with loops of tensor operations and autograd, so the
plain PyTorch version is the port's function everywhere. Everything is
fp32; tolerances are stated per test. The train steps run both Trainers
with the criterion in eval mode, as tests/test_torch_ctc.py does."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbk_fairseq_st_tpu import options, registry
from fbk_fairseq_st_tpu.criterions import asg as jcrit
from fbk_fairseq_st_tpu.data import replabels as jrep
from fbk_fairseq_st_tpu.data.dictionary import Dictionary as JaxDictionary
from fbk_fairseq_st_tpu.ops import asg as jasg
from fbk_fairseq_st_tpu.train.trainer import Trainer as JaxTrainer
from fbk_fairseq_st_tpu.utils.fairseq_interop import export_parameters
from fbk_fairseq_st_tpu_torch.criterions import CRITERIONS, ASGCriterion
from fbk_fairseq_st_tpu_torch.data import Dictionary
from fbk_fairseq_st_tpu_torch.data import replabels as trep
from fbk_fairseq_st_tpu_torch.models import w2l_conv_glu as tw2l
from fbk_fairseq_st_tpu_torch.ops import asg as tasg
from fbk_fairseq_st_tpu_torch.tasks import SpeechRecognitionTask
from fbk_fairseq_st_tpu_torch.train import Trainer
from fbk_fairseq_st_tpu_torch.utils.weights import state_dict_from_jax

from .utils import DummyTask, model_args

SYMBOLS = ("a", "b", "c", "d", "|")
FEAT = 8
W2L = dict(input_feat_per_channel=FEAT, conv_enc_config="[(12, 3, 1, 0.1), (10, 5, 2, 0.2)]")


def _np(x):
    return np.asarray(x.detach()) if isinstance(x, torch.Tensor) else np.asarray(x)


def _dicts(max_reps=2):
    """JAX's and the port's dictionary of the same symbols, the replabel
    symbols last (as the task adds them)."""
    out = []
    for cls in (JaxDictionary, Dictionary):
        d = cls()
        for s in SYMBOLS + tuple(str(i) for i in range(1, max_reps + 1)):
            d.add_symbol(s)
        out.append(d)
    return out


# ---------------------------------------------------------------------------
# replabels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_reps", [1, 2, 3])
def test_replabels_match_jax(max_reps):
    """pack_replabels / unpack_replabels give JAX's ids on 40 seeded
    sequences of repeats (runs up to 5, empty included); unpack inverts
    pack; a dictionary without the symbols raises in both."""
    jd, td = _dicts(max_reps)
    rng = np.random.RandomState(max_reps)
    letters = [td.index(s) for s in ("a", "b", "c")]
    for n in range(40):
        seq = []
        for _ in range(rng.randint(0, 5)):
            seq += [int(rng.choice(letters))] * int(rng.randint(1, 6))
        packed = trep.pack_replabels(seq, td, max_reps)
        assert packed == jrep.pack_replabels(seq, jd, max_reps)
        assert trep.unpack_replabels(packed, td, max_reps) == jrep.unpack_replabels(packed, jd, max_reps) == seq
    bare_j, bare_t = JaxDictionary(), Dictionary()
    for d in (bare_j, bare_t):
        d.add_symbol("a")
    for mod, d in ((jrep, bare_j), (trep, bare_t)):
        with pytest.raises(ValueError, match="replabel symbol"):
            mod.pack_replabels([4, 4], d, 2)


# ---------------------------------------------------------------------------
# the loss and the decode
# ---------------------------------------------------------------------------

def _asg_inputs(seed=0, b=4, t=9, v=6, n=5):
    rng = np.random.RandomState(seed)
    em = rng.randn(b, t, v).astype(np.float32)
    trans = (0.5 * rng.randn(v, v)).astype(np.float32)
    tgt = rng.randint(0, v, size=(b, n)).astype(np.int64)
    in_len = np.array([t, 7, 3, 1][:b])
    tgt_len = np.array([n, 3, 1, 1][:b])
    return em, trans, tgt, in_len, tgt_len


@pytest.mark.parametrize("scale_mode", ["target_sz_sqrt", "none", "input_sz"])
def test_asg_loss_and_gradients_match_jax(scale_mode):
    """The per-utterance losses and the gradient of their weighted sum in
    the emissions and in the transitions within 1e-5 of ``jax.grad``'s,
    with rows of every length (1 frame included) and the scale modes."""
    em, trans, tgt, in_len, tgt_len = _asg_inputs()
    w = np.array([1.0, 0.5, -2.0, 1.5], np.float32)

    def jloss(e, tr):
        losses = jasg.asg_loss(e, tr, jnp.asarray(tgt), jnp.asarray(in_len), jnp.asarray(tgt_len), scale_mode)
        return jnp.sum(losses * w), losses

    (_, jlosses), (jge, jgt) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(em), jnp.asarray(trans))
    te, tt = torch.tensor(em, requires_grad=True), torch.tensor(trans, requires_grad=True)
    losses = tasg.asg_loss(te, tt, torch.tensor(tgt), torch.tensor(in_len), torch.tensor(tgt_len), scale_mode)
    (losses * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(_np(losses), np.asarray(jlosses), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(te.grad), np.asarray(jge), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(tt.grad), np.asarray(jgt), rtol=0, atol=1e-5)
    assert np.abs(np.asarray(jgt)).max() > 1e-3  # the transitions take part


def test_viterbi_paths_match_jax():
    """Best paths exactly and their scores within 1e-5, on scores with
    frequent ties (a coarse grid) and rows of every length."""
    em, trans, _, in_len, _ = _asg_inputs(seed=1)
    em = np.round(em)
    trans = np.round(trans * 2) / 2
    jpaths, jscores = jasg.asg_viterbi_decode(jnp.asarray(em), jnp.asarray(trans), jnp.asarray(in_len))
    tpaths, tscores = tasg.asg_viterbi_decode(torch.tensor(em), torch.tensor(trans), torch.tensor(in_len))
    np.testing.assert_array_equal(_np(tpaths), np.asarray(jpaths))
    np.testing.assert_allclose(_np(tscores), np.asarray(jscores), rtol=0, atol=1e-5)


@pytest.mark.parametrize("training", [True, False], ids=["train", "valid"])
def test_prepare_sample_matches_jax(training):
    """The packed targets, their lengths and the token count equal JAX's:
    eos replaced by the silence token, runs packed into replabels, cut to
    the frames, LinSeg-stretched in training only, a padding row of
    length 0 kept out."""
    jd, td = _dicts()
    args = argparse.Namespace(max_replabel=2, linseg_updates=5, hide_linseg_messages=True, silence_token="|",
                              asg_scale_mode="target_sz_sqrt")
    a, b, c = (td.index(s) for s in "abc")
    target = np.array([[a, a, a, b, 2], [c, c, b, 2, 1], [a, b, 1, 1, 1], [1, 1, 1, 1, 1]], np.int64)
    sample = {"target": target, "target_lengths": (target != 1).sum(axis=1),
              "net_input": {"src_lengths": np.array([9, 6, 1, 0])}, "ntokens": 10}
    want = jcrit.ASGCriterion(DummyTask(jd), args).prepare_sample(dict(sample), 0, training=training)
    got = ASGCriterion(DummyTask(td), args).prepare_sample(dict(sample), 0, training=training)
    for key in ("asg_target", "asg_target_lengths", "asg_ntokens"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert int(got["asg_target_lengths"][0]) == (9 if training else 4)


# ---------------------------------------------------------------------------
# the w2l model and the train steps
# ---------------------------------------------------------------------------

def test_w2l_logits_and_bridge_match_jax():
    """``w2l_conv_glu_enc`` under ``asg_loss``: the bridge equals
    ``export_parameters`` (the (K, C_in, C_out) convs as they are,
    ``asg_transitions`` untransposed), loads strictly, and the logits in
    eval mode agree within 1e-5 and are the ``ctc_out`` with the input
    lengths; a stack that changes the frame count raises in both."""
    jd, td = _dicts()
    args = model_args("w2l_conv_glu_enc", **W2L, criterion="asg_loss", asg_transitions_init=0.5)
    registry.apply_architecture(args)
    jmodel = registry.build_model(args, DummyTask(jd))
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(2)))
    ours, theirs = state_dict_from_jax(variables), export_parameters(variables)
    assert sorted(ours) == sorted(theirs) and "asg_transitions" in ours
    for name, arr in theirs.items():
        np.testing.assert_array_equal(ours[name].numpy(), arr, err_msg=name)
    tmodel = tw2l.build_model("w2l_conv_glu_enc", td, device="cpu", criterion="asg_loss", asg_transitions_init=0.5,
                              **W2L)
    np.testing.assert_array_equal(_np(tmodel.asg_transitions), variables["params"]["asg_transitions"])
    tmodel.load_state_dict(ours, strict=True)
    rng = np.random.RandomState(3)
    x, lengths = rng.randn(2, 13, FEAT).astype(np.float32), np.array([13, 9])
    (jlogits, _), _ = jax.jit(jmodel.forward)(variables, {"src_tokens": jnp.asarray(x),
                                                           "src_lengths": jnp.asarray(lengths)})
    with torch.no_grad():
        tlogits, extra = tmodel({"src_tokens": torch.tensor(x), "src_lengths": torch.tensor(lengths)})
    np.testing.assert_allclose(_np(tlogits), np.asarray(jlogits), rtol=0, atol=1e-5)
    assert extra["encoder_out"].ctc_out is tlogits
    np.testing.assert_array_equal(_np(extra["encoder_out"].ctc_lengths), lengths)
    with pytest.raises(ValueError, match="preserve sequence length"):
        tw2l.build_model("w2l_conv_glu_enc", td, device="cpu", input_feat_per_channel=FEAT,
                         conv_enc_config="[(12, 3, 0, 0.1)]")
    assert tw2l.build_model("w2l_conv_glu_enc", td, device="cpu", **W2L).asg_transitions is None


TRAIN_ARGV = ["/nonexistent", "--task", "speech_recognition", "--arch", "w2l_conv_glu_enc",
              "--criterion", "asg_loss", "--max-replabel", "2", "--asg-transitions-init", "0.3",
              "--optimizer", "adam", "--lr", "0.01", "--lr-scheduler", "fixed", "--max-tokens", "4000",
              "--distributed-world-size", "1", "--silence-token", "|"] + \
    [f"--{k.replace('_', '-')}={v}" for k, v in W2L.items()]


class _EvalJaxASG(jcrit.ASGCriterion):
    def __call__(self, model, variables, batch, rng=None, training=False):
        return super().__call__(model, variables, batch, rng=rng, training=False)


class _EvalASG(ASGCriterion):
    def __call__(self, model, batch, generator=None, training=False):
        return super().__call__(model, batch, generator, training=False)


def _train_sample(seed, td):
    rng = np.random.RandomState(seed)
    letters = [td.index(s) for s in "abcd"]
    rows = [[int(x) for x in rng.choice(letters, size=n)] + [2] for n in (6, 4, 3)]
    rows[0][1] = rows[0][2] = rows[0][0]  # a run to pack
    target = np.ones((3, 7), np.int64)
    for i, r in enumerate(rows):
        target[i, : len(r)] = r
    lengths = np.array([15, 12, 8])
    return {"net_input": {"src_tokens": rng.randn(3, 15, FEAT).astype(np.float32), "src_lengths": lengths},
            "target": target, "target_lengths": (target != 1).sum(axis=1), "ntokens": int((target != 1).sum()),
            "nsentences": 3}


def test_asg_train_steps_match_jax_trainer():
    """Two ``asg_loss`` updates of a tiny w2l (Adam, the transitions
    learned with the rest) by the port's Trainer against JAX's: the loss
    and the gnorm at rtol 1e-5, the counts exactly, then every parameter,
    ``asg_transitions`` included, at atol 1e-5; the criterion is the
    port's registered ``asg_loss`` and the task adds the replabel
    symbols."""
    args = options.parse_args_and_arch(options.get_training_parser(), TRAIN_ARGV)
    jd, td = _dicts()
    jtask = DummyTask(jd)
    jmodel = registry.build_model(args, jtask)
    jtrainer = JaxTrainer(args, jtask, jmodel, _EvalJaxASG(jtask, args))
    gnorms = []
    log_training = jtrainer._log_training
    jtrainer._log_training = lambda lo, gnorm, meta: (gnorms.append(gnorm), log_training(lo, gnorm, meta))
    ttask = SpeechRecognitionTask(args, td)
    assert CRITERIONS["asg_loss"] is ASGCriterion
    tmodel = ttask.build_model(args, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jtrainer.variables())),
                           strict=True)
    ttrainer = Trainer(args, ttask, tmodel, _EvalASG(ttask, args))
    for step in range(2):
        sample = _train_sample(step, td)
        want = jtrainer.train_step([sample])
        got = ttrainer.train_step([sample])
        np.testing.assert_allclose(float(got["loss"]), want["loss"], rtol=1e-5, err_msg=f"loss step {step}")
        assert int(got["ntokens"]) == want["ntokens"] and int(got["sample_size"]) == want["sample_size"]
        np.testing.assert_allclose(float(got["gnorm"]), gnorms[step], rtol=1e-5, err_msg=f"gnorm step {step}")
    want_sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jtrainer.variables()))
    got_sd = ttrainer.model.state_dict()
    assert sorted(got_sd) == sorted(want_sd)
    for name, value in want_sd.items():
        np.testing.assert_allclose(_np(got_sd[name]), value.numpy(), rtol=0, atol=1e-5, err_msg=name)
    assert not np.allclose(_np(got_sd["asg_transitions"]), 0.3 * np.eye(len(td)))


def test_task_adds_the_replabel_symbols(tmp_path):
    """Under ``asg_loss`` the task appends "1" .. ``--max-replabel`` to the
    loaded dictionary, as JAX's does."""
    with open(tmp_path / "dict.txt", "w") as f:
        f.write("a 5\nb 3\n| 2\n")
    ns = argparse.Namespace(data=str(tmp_path), target_lang=None, criterion="asg_loss", max_replabel=3)
    task = SpeechRecognitionTask.setup_task(ns)
    assert [task.target_dictionary[i] for i in range(len(task.target_dictionary))][-3:] == ["1", "2", "3"]
