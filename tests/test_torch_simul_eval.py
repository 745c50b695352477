"""PyTorch port, simultaneous decoding: the greedy READ/WRITE agent
(``generation/simultaneous_decoder.py``) and ``cli/simul_eval`` against
the JAX package on the CPU, and the serving CLIs' raise.

The agent runs on one-layer, 16-wide models (JAX's weights drawn in the
shapes of ``jax.eval_shape(model.init)``); JAX's agent calls
``model.forward`` at each READ or WRITE, here through a jitted wrapper (an
eager forward compiles its ops at every new shape). cli/simul_eval runs
on JAX's cli/train checkpoint of a one-layer MMA-IL model trained one
epoch with the latency criterion, on a 12-pair corpus (4 test pairs).
A p_choose within rounding of the 0.5 threshold would flip a READ/WRITE
decision between the packages: the tests compare the decisions as they
fall, and report a mismatch as it is."""

import logging
import os

import jax
import numpy as np
import pytest

from fbk_fairseq_st_tpu import registry
from fbk_fairseq_st_tpu.cli import simul_eval as jax_simul_eval
from fbk_fairseq_st_tpu.cli import train as jax_train_cli
from fbk_fairseq_st_tpu.generation import simultaneous_decoder as jsd
from fbk_fairseq_st_tpu_torch import models as tmodels
from fbk_fairseq_st_tpu_torch.cli import export_serving as t_export_serving
from fbk_fairseq_st_tpu_torch.cli import serve as t_serve
from fbk_fairseq_st_tpu_torch.cli import simul_eval as t_simul_eval
from fbk_fairseq_st_tpu_torch.generation import simultaneous_decoder as tsd
from fbk_fairseq_st_tpu_torch.utils.weights import state_dict_from_jax

from .test_torch_model import random_variables, torch_dictionary
from .test_translation import create_translation_data
from .torch_shared import session_root, shared
from .utils import dummy_dictionary, model_args

VOCAB = 24
EOS = 2
ONE_LAYER = dict(encoder_layers=1, decoder_layers=1, encoder_embed_dim=16, decoder_embed_dim=16,
                 encoder_ffn_embed_dim=32, decoder_ffn_embed_dim=32, encoder_attention_heads=2,
                 decoder_attention_heads=2, max_source_positions=64, max_target_positions=64)
AGENT = {"hard_aligned": dict(simul_type="hard_aligned"), "waitk": dict(simul_type="waitk", waitk_lagging=2)}


class _Task:
    def __init__(self, d):
        self.source_dictionary = d
        self.target_dictionary = d


class _Jitted:
    """JAX's model as its agent reads it (``mono_cfg``, ``forward``), the
    forward jitted."""

    def __init__(self, model):
        self.mono_cfg = model.mono_cfg
        self._forward = jax.jit(lambda v, b: model.forward(v, b))

    def forward(self, variables, batch):
        return self._forward(variables, batch)


@pytest.mark.parametrize("name", sorted(AGENT))
def test_greedy_agent_matches_jax(name):
    """The agent's tokens and delays equal JAX's, and its AP / AL / DAL
    within 1e-6; wait-k's first delay is k."""
    over = AGENT[name]
    args = model_args("transformer_monotonic", **ONE_LAYER, **over)
    registry.apply_architecture(args)
    jmodel = registry.build_model(args, _Task(dummy_dictionary(VOCAB)))
    variables = random_variables(jmodel, 0)
    td = torch_dictionary(VOCAB)
    tmodel = tmodels.build_model("transformer_monotonic", td, td, device="cpu", **ONE_LAYER, **over)
    tmodel.load_state_dict(state_dict_from_jax(variables), strict=True)
    src = np.array([5, 6, 7, 8, EOS])
    want = jsd.greedy_simul_decode(_Jitted(jmodel), variables, src, eos=EOS, max_len=4)
    got = tsd.greedy_simul_decode(tmodel, src, eos=EOS, max_len=4)
    assert (got["tokens"], got["delays"]) == (want["tokens"], want["delays"])
    assert got["latency"].keys() == want["latency"].keys()
    for key in want["latency"]:
        assert abs(got["latency"][key] - want["latency"][key]) <= 1e-6
    if name == "waitk":
        assert got["delays"][0] == 2


SIMUL_TRAIN = ["--task", "translation", "-s", "en", "-t", "de", "--arch", "transformer_monotonic",
               "--simul-type", "infinite_lookback", "--criterion", "latency_augmented_label_smoothed_cross_entropy",
               "--label-smoothing", "0.1", "--latency-weight-avg", "0.1", "--latency-weight-var", "0.1",
               "--optimizer", "adam", "--lr", "0.001", "--lr-scheduler", "fixed", "--max-tokens", "200",
               "--max-epoch", "1", "--encoder-layers", "1", "--decoder-layers", "1", "--encoder-embed-dim", "16",
               "--decoder-embed-dim", "16", "--encoder-ffn-embed-dim", "32", "--decoder-ffn-embed-dim", "32",
               "--encoder-attention-heads", "2", "--decoder-attention-heads", "2", "--max-source-positions", "64",
               "--max-target-positions", "64", "--log-format", "none"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The corpus and JAX's trained checkpoint, made once for the session."""

    def make(directory):
        data_dir, save_dir = os.path.join(directory, "data"), os.path.join(directory, "ckpt")
        create_translation_data(data_dir, n=12)
        jax_train_cli.cli_main([data_dir, "--save-dir", save_dir] + SIMUL_TRAIN)
        return data_dir, os.path.join(save_dir, "checkpoint_last.pt")

    return shared(session_root(tmp_path_factory), "simul_trained", make)


def _records(text):
    return [line for line in text.splitlines() if line.startswith(("H-", "DEL-", "LAT-"))]


def test_simul_eval_cli_matches_jax(trained, capsys, caplog, monkeypatch):
    """cli/simul_eval's H-, DEL- and LAT- lines equal JAX's byte for byte,
    and so does the corpus log line's message (JAX's forwards jitted by
    wrapping the model its loader returns)."""
    data_dir, ckpt = trained
    load = jax_simul_eval.checkpoint_utils.load_model_ensemble

    def jitted_load(*args, **kwargs):
        models, margs = load(*args, **kwargs)
        return [(_Jitted(m), v) for m, v in models], margs

    monkeypatch.setattr(jax_simul_eval.checkpoint_utils, "load_model_ensemble", jitted_load)
    argv = [data_dir, "--task", "translation", "-s", "en", "-t", "de", "--path", ckpt, "--gen-subset", "test",
            "--max-len-b", "4", "--log-format", "none"]
    caplog.set_level(logging.INFO)
    capsys.readouterr()
    jax_simul_eval.cli_main(argv)
    want = capsys.readouterr().out
    t_simul_eval.cli_main(argv + ["--cpu"])
    got = capsys.readouterr().out
    assert _records(got) == _records(want) and len(_records(got)) == 12
    corpus = [r.getMessage() for r in caplog.records if r.getMessage().startswith("Simultaneous eval on")]
    assert len(corpus) == 2 and corpus[0] == corpus[1], corpus


def test_serving_clis_raise_naming_the_item():
    """cli/serve and cli/export_serving are item 9(c)'s serving half: each
    raises naming it."""
    for cli in (t_serve, t_export_serving):
        with pytest.raises(NotImplementedError, match=r"9\(c\)"):
            cli.cli_main([])
