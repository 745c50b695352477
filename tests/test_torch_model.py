"""PyTorch port, slice level: the conv_transformer serving path against the
JAX package on the same weights and inputs, on the CPU.

The JAX model is built from its registry, its variables go through the
port's ``state_dict_from_jax`` and load strictly into the port's model.
The port runs on ``device="cpu"`` with its plain versions. Tolerances are
stated per test."""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbk_fairseq_st_tpu import registry
from fbk_fairseq_st_tpu.generation import SequenceGenerator as JaxSequenceGenerator
from fbk_fairseq_st_tpu.ops import attention as jattn
from fbk_fairseq_st_tpu.utils.fairseq_interop import export_parameters
from fbk_fairseq_st_tpu_torch import device as tdevice
from fbk_fairseq_st_tpu_torch.data import Dictionary as TorchDictionary
from fbk_fairseq_st_tpu_torch.generation import SequenceGenerator
from fbk_fairseq_st_tpu_torch.models import conv_transformer as tct
from fbk_fairseq_st_tpu_torch.ops import attention as tattn
from fbk_fairseq_st_tpu_torch.utils.weights import state_dict_from_jax

from .utils import DummyTask, dummy_dictionary, model_args

REPO = pathlib.Path(__file__).resolve().parents[1]
VOCAB = 40
SMALL = dict(
    encoder_layers=2,
    decoder_layers=2,
    encoder_embed_dim=32,
    decoder_embed_dim=32,
    encoder_ffn_embed_dim=64,
    decoder_ffn_embed_dim=64,
    encoder_attention_heads=2,
    decoder_attention_heads=2,
    max_source_positions=64,
    max_target_positions=32,
    input_feat_per_channel=16,
)
VARIANTS = {
    "base": {},
    "tied_learned_gauss": dict(
        share_decoder_input_output_embed=True,
        encoder_learned_pos=True,
        decoder_learned_pos=True,
        distance_penalty="gauss",
    ),
}


def torch_dictionary(n: int = VOCAB) -> TorchDictionary:
    d = TorchDictionary()
    for i in range(n):
        d.add_symbol(f"tok{i}")
    d.finalize(padding_factor=1)
    return d


def _build_pair(**over):
    jd = dummy_dictionary(VOCAB)
    args = model_args("conv_transformer", **SMALL, **over)
    registry.apply_architecture(args)
    jmodel = registry.build_model(args, DummyTask(jd))
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    td = torch_dictionary()
    tmodel = tct.build_model("conv_transformer", td, device="cpu", seed=1, **SMALL, **over)
    tmodel.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jd, jmodel, variables, td, tmodel


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def pair(request):
    return _build_pair(**VARIANTS[request.param])


@pytest.fixture
def flash_routes():
    def set_both(enabled):
        jattn.set_flash_attention(enabled)
        tattn.set_flash_attention(enabled)
    yield set_both
    jattn.set_flash_attention(None)
    tattn.set_flash_attention(None)


def _batch(seed=0, b=3, t=37, tgt_len=7):
    rng = np.random.RandomState(seed)
    lengths = np.array([t, t - 8, t - 15][:b], np.int32)
    prev = np.concatenate(
        [np.full((b, 1), 2), rng.randint(4, VOCAB, size=(b, tgt_len - 1))], axis=1
    ).astype(np.int32)
    prev[-1, -2:] = 1  # padded target tail: exercises the self key-padding mask
    return {
        "src_tokens": rng.randn(b, t, SMALL["input_feat_per_channel"]).astype(np.float32),
        "src_lengths": lengths,
        "prev_output_tokens": prev,
    }


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_state_dict_from_jax_matches_export_parameters(variant):
    """Same names and exactly the same values as the JAX package's fork
    export on the same tree; the port's model loads them strictly."""
    _, _, variables, _, tmodel = _build_pair(**VARIANTS[variant])
    ours = state_dict_from_jax(variables)
    theirs = export_parameters(variables)
    assert sorted(ours) == sorted(theirs)
    for name, arr in theirs.items():
        np.testing.assert_array_equal(ours[name].numpy(), arr, err_msg=name)
    assert sorted(tmodel.state_dict()) == sorted(ours)


# ---------------------------------------------------------------------------
# the whole slice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["dense", "flash"])
def test_teacher_forced_logits_match_jax(pair, route, flash_routes):
    """Encoder output and teacher-forced logits of the whole model in eval
    mode at atol 1e-4; JAX's flash route runs its Pallas kernel in
    interpret mode, the port's its plain version."""
    _, jmodel, variables, _, tmodel = pair
    batch = _batch()
    flash_routes(route == "flash")
    (jlogits, jextra), _ = jmodel.forward(
        variables, {k: jnp.asarray(v) for k, v in batch.items()}, training=False
    )
    with torch.no_grad():
        tlogits, textra = tmodel({k: torch.tensor(v).long() if v.dtype != np.float32 else torch.tensor(v)
                                  for k, v in batch.items()})
    np.testing.assert_array_equal(
        textra["encoder_out"].encoder_padding_mask.numpy(),
        np.asarray(jextra["encoder_out"].encoder_padding_mask),
    )
    np.testing.assert_allclose(
        textra["encoder_out"].encoder_out.numpy(),
        np.asarray(jextra["encoder_out"].encoder_out), rtol=0, atol=1e-4,
    )
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=0, atol=1e-4)


GENERATOR_CASES = {
    "beam5": dict(beam_size=5, max_len_b=12),
    "beam5_lenpen_ngram_unk_minlen": dict(
        beam_size=5, max_len_b=10, len_penalty=1.3, no_repeat_ngram_size=2,
        unk_penalty=0.5, min_len=3,
    ),
}


@pytest.mark.parametrize("case", sorted(GENERATOR_CASES))
def test_beam_search_matches_jax(pair, case):
    """SequenceGenerator.generate against JAX's on the same weights:
    token-identical hypotheses in the same order, scores and positional
    scores within 1e-4."""
    jd, jmodel, variables, td, tmodel = pair
    batch = _batch(seed=4)
    sample = {"net_input": {"src_tokens": batch["src_tokens"], "src_lengths": batch["src_lengths"]}}
    kwargs = GENERATOR_CASES[case]
    want = JaxSequenceGenerator(jd, **kwargs).generate([(jmodel, variables)], sample)
    got = SequenceGenerator(td, **kwargs).generate([tmodel], sample)
    assert len(got) == len(want)
    for hyps_t, hyps_j in zip(got, want):
        assert len(hyps_t) == len(hyps_j) == kwargs["beam_size"]
        for ht, hj in zip(hyps_t, hyps_j):
            np.testing.assert_array_equal(ht["tokens"], np.asarray(hj["tokens"]))
            assert abs(ht["score"] - hj["score"]) <= 1e-4
            np.testing.assert_allclose(ht["positional_scores"], hj["positional_scores"], rtol=0, atol=1e-4)


def test_prefix_tokens_force_the_continuation():
    jd, jmodel, variables, td, tmodel = _build_pair()
    batch = _batch(seed=5)
    sample = {"net_input": {"src_tokens": batch["src_tokens"], "src_lengths": batch["src_lengths"]}}
    prefix = np.array([[7, 9], [11, 1], [5, 6]], np.int64)
    want = JaxSequenceGenerator(jd, beam_size=3, max_len_b=6).generate(
        [(jmodel, variables)], sample, prefix_tokens=prefix)
    got = SequenceGenerator(td, beam_size=3, max_len_b=6).generate([tmodel], sample, prefix_tokens=prefix)
    for hyps_t, hyps_j in zip(got, want):
        for ht, hj in zip(hyps_t, hyps_j):
            np.testing.assert_array_equal(ht["tokens"], np.asarray(hj["tokens"]))
            assert abs(ht["score"] - hj["score"]) <= 1e-4
    assert all(list(h["tokens"][:2]) == [7, 9] for h in got[0])


# ---------------------------------------------------------------------------
# package rules
# ---------------------------------------------------------------------------

def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = sorted((REPO / "fbk_fairseq_st_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        roots = set(_imported_roots(path))
        assert not roots & {"jax", "jaxlib", "flax", "optax", "fbk_fairseq_st_tpu"}, (path, roots)


def test_entry_points_need_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tdevice.resolve_device(None)
    with pytest.raises(RuntimeError):
        tct.build_model("conv_transformer", torch_dictionary(), **SMALL)
    assert tdevice.resolve_device("cpu") == torch.device("cpu")


def test_off_path_options_raise():
    for option in (dict(adaptive_softmax_cutoff="1000,4000"), dict(adaptive_input=True)):
        with pytest.raises(NotImplementedError):
            tct.build_model("conv_transformer", torch_dictionary(), device="cpu", **option, **SMALL)
    with pytest.raises(TypeError):
        tct.build_model("conv_transformer", torch_dictionary(), device="cpu", no_such_option=1)


@pytest.mark.parametrize("arch", sorted(tct.ARCHITECTURES))
def test_arch_presets_match_jax(arch):
    """Each preset builds the same encoder/decoder configs as the JAX
    registry's (compared field by field). The JAX decoder config's fields
    of other model families, which the port's lacks, stay at their
    defaults."""
    jd = dummy_dictionary(VOCAB)
    args = model_args(arch)
    registry.apply_architecture(args)
    jmodel = registry.build_model(args, DummyTask(jd))
    enc, dec = tct.configs(arch, torch_dictionary())
    assert enc.frontend._asdict() == jmodel.encoder_cfg.frontend._asdict()
    assert {k: v for k, v in enc._asdict().items() if k != "frontend"} == {
        k: v for k, v in jmodel.encoder_cfg._asdict().items() if k != "frontend"
    }
    jdec = jmodel.decoder_cfg._asdict()
    assert dec._asdict() == {k: jdec[k] for k in dec._fields}
    jdefaults = type(jmodel.decoder_cfg)._field_defaults
    assert {k: v for k, v in jdec.items() if k not in dec._fields} == {
        k: jdefaults[k] for k in jdec if k not in dec._fields
    }


def test_dictionary_matches_jax():
    from fbk_fairseq_st_tpu.data.dictionary import Dictionary as JaxDictionary

    words = "b a c a d b a e".split()
    jd, td = JaxDictionary(), TorchDictionary()
    for w in words:
        jd.add_symbol(w)
        td.add_symbol(w)
    jd.finalize(padding_factor=8)
    td.finalize(padding_factor=8)
    assert td.symbols == jd.symbols and td.indices == jd.indices
    assert (td.pad(), td.eos(), td.unk(), td.bos()) == (jd.pad(), jd.eos(), jd.unk(), jd.bos())
    ids = np.array([td.index("a"), td.index("zz"), td.index("b"), td.eos(), td.pad()])
    assert td.string(ids) == jd.string(ids)
    assert td.string(np.array([td.index("a"), td.index("b")]), bpe_symbol="a") == jd.string(
        np.array([jd.index("a"), jd.index("b")]), bpe_symbol="a")
