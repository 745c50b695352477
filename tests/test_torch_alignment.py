"""PyTorch port, attention alignments and ``--replace-unk`` against JAX.

The decoder's ``need_attn`` (the last layer's head-averaged
cross-attention) within 1e-5 of JAX's on the same weights and inputs, the
logits unchanged by it, and only that one attention off the flash route
(the calls of ``ops.attention.flash_attention`` counted: a teacher-forced
decoder forward makes one fewer). Then ``cli/generate --print-alignment
--replace-unk`` (``--unkpen -5`` so that the random weights emit unknown
words) of both packages on the same JAX checkpoint: the A- lines and the
H-/D- lines (unknown words replaced) equal, the scores within 1e-4 (base
2), for ``conv_transformer`` on tests/test_torch_generate_cli.py's corpus
and for a tiny ``dynamicconv_iwslt_de_en`` on a translation corpus, whose
decoder gives no attention in either package (no A- lines, the unknown
words kept). A replacement dictionary (``--replace-unk FILE``) maps the
aligned source word, as in JAX."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbk_fairseq_st_tpu import options as joptions
from fbk_fairseq_st_tpu import registry
from fbk_fairseq_st_tpu.cli import generate as jgenerate
from fbk_fairseq_st_tpu.data import Dictionary as JaxDictionary
from fbk_fairseq_st_tpu.train.checkpoint import save_state
from fbk_fairseq_st_tpu_torch.cli import generate as tgenerate
from fbk_fairseq_st_tpu_torch.ops import attention as tattn
from fbk_fairseq_st_tpu_torch.utils import align_utils

from .test_torch_generate_cli import corpus  # noqa: F401  (the module fixture)
from .test_torch_interactive import ARCH as LC_ARCH
from .test_torch_model import _batch, _build_pair, shared_root  # noqa: F401  (the fixture)
from .test_translation import create_translation_data
from .utils import DummyTask

ATTN_ATOL = 1e-5
SCORE_ATOL = 1e-4


def test_decoder_attention_matches_jax():
    _, jmodel, variables, _, tmodel = _build_pair()
    batch = _batch(seed=2)

    @jax.jit
    def forward(v, src, lengths, prev):
        enc, _ = jmodel.encode(v, src, lengths)
        return jmodel.decoder(v["params"]["decoder"], prev, encoder_out=enc.encoder_out,
                              encoder_padding_mask=enc.encoder_padding_mask, need_attn=True)

    jlogits, jextra = forward(variables, jnp.asarray(batch["src_tokens"]), jnp.asarray(batch["src_lengths"]),
                              jnp.asarray(batch["prev_output_tokens"]))
    prev = torch.tensor(batch["prev_output_tokens"]).long()
    with torch.no_grad():
        tenc = tmodel.encode(torch.tensor(batch["src_tokens"]), torch.tensor(batch["src_lengths"]).long())
        tlogits, textra = tmodel.decoder(prev, tenc.encoder_out, tenc.encoder_padding_mask, need_attn=True)
        plain, plain_extra = tmodel.decoder(prev, tenc.encoder_out, tenc.encoder_padding_mask)
    attn = np.asarray(jextra["attn"])
    assert textra["attn"].shape == attn.shape == (3, 7, tenc.encoder_out.shape[1])
    np.testing.assert_allclose(textra["attn"].numpy(), attn, rtol=0, atol=ATTN_ATOL)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tlogits.numpy(), plain.numpy(), rtol=0, atol=1e-5)
    assert plain_extra == {"attn": None}
    # padded keys get no weight, and each row sums to 1
    mask = tenc.encoder_padding_mask.numpy()[:, None, :].repeat(7, axis=1)
    assert np.all(textra["attn"].numpy()[mask] == 0)
    np.testing.assert_allclose(textra["attn"].sum(-1).numpy(), 1.0, atol=1e-5)


def test_only_the_last_cross_attention_leaves_the_flash_route(monkeypatch):
    """With the flash route forced, a teacher-forced forward of a 2-layer
    decoder calls ``flash_attention`` 4 times (2 self, 2 cross) and, with
    ``need_attn``, 3 times: the last layer's cross-attention takes the
    dense route, every other call stays on the flash one."""
    _, _, _, _, tmodel = _build_pair()
    batch = _batch(seed=3)
    calls = []
    original = tattn.flash_attention

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return original(*args, **kwargs)

    monkeypatch.setattr(tattn, "flash_attention", counted)
    tattn.set_flash_attention(True)
    try:
        with torch.no_grad():
            enc = tmodel.encode(torch.tensor(batch["src_tokens"]), torch.tensor(batch["src_lengths"]).long())
            prev = torch.tensor(batch["prev_output_tokens"]).long()
            n_enc = len(calls)
            tmodel.decoder(prev, enc.encoder_out, enc.encoder_padding_mask)
            n_plain = len(calls) - n_enc
            tmodel.decoder(prev, enc.encoder_out, enc.encoder_padding_mask, need_attn=True)
            n_attn = len(calls) - n_enc - n_plain
    finally:
        tattn.set_flash_attention(None)
    assert n_enc == 2  # the 2 encoder layers (the conv front end binds its own name)
    assert (n_plain, n_attn) == (4, 3)


def _records(path):
    out = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            head = line.split("\t")[0]
            if "-" in head and head.split("-")[0] in ("S", "T", "H", "D", "P", "A"):
                kind, sid = head.split("-", 1)
                out.setdefault(kind, {}).setdefault(int(sid), []).append(line.rstrip("\n").split("\t")[1:])
    return out


def _compare(got, want):
    assert set(got) == set(want)
    for kind in ("S", "T", "A"):
        assert got.get(kind) == want.get(kind), kind
    for kind in ("H", "D"):
        assert sorted(got[kind]) == sorted(want[kind])
        for sid, rows in want[kind].items():
            for g, w in zip(got[kind][sid], rows):
                assert g[1] == w[1], (kind, sid, g, w)
                assert abs(float(g[0]) - float(w[0])) <= SCORE_ATOL


def _run_both(root, argv, name):
    jres, tres = os.path.join(root, f"jax_{name}"), os.path.join(root, f"port_{name}")
    jscorer = jgenerate.cli_main(argv + ["--results-path", jres])
    tscorer = tgenerate.cli_main(argv + ["--results-path", tres])
    want = _records(os.path.join(jres, "generate-test.txt"))
    got = _records(os.path.join(tres, "generate-test.txt"))
    return got, want, tscorer, jscorer


@pytest.mark.parametrize("replace", ["copy", "dictionary"])
def test_conv_transformer_alignments_and_unk_replacement_match_jax(corpus, replace):  # noqa: F811
    root, data_dir, pickled, _ = corpus
    extra = ["--print-alignment", "--replace-unk"]
    if replace == "dictionary":
        # the audio source has no words: every aligned position is past
        # them, where the reference's appended <eos> is the word
        align = os.path.join(root, "align_dict.txt")
        with open(align, "w") as f:
            f.write("<eos> REPLACED\n")
        extra.append(align)
    argv = [data_dir, "--task", "speech_translation_with_transcription", "-s", "en", "-t", "de", "--path", pickled,
            "--beam", "3", "--max-len-b", "8", "--gen-subset", "test", "--max-sentences", "4", "--cpu",
            "--unkpen", "-5", *extra]
    got, want, tscorer, jscorer = _run_both(root, argv, f"align_{replace}")
    _compare(got, want)
    assert len(got["A"]) == 6
    for sid, rows in got["A"].items():
        assert len(rows[0][0].split()) == len(got["P"][sid][0][0].split())
    hyps = " ".join(r[0][1] for r in got["H"].values())
    assert ("REPLACED" in hyps) == (replace == "dictionary")
    assert tscorer.result_string() == jscorer.result_string()


@pytest.fixture(scope="module")
def lightconv(tmp_path_factory):
    """A translation corpus and seeded JAX weights of a tiny
    ``dynamicconv_iwslt_de_en`` (tests/test_torch_interactive.py's widths)."""
    root = str(tmp_path_factory.mktemp("alignment_lc"))
    data_dir = os.path.join(root, "data")
    create_translation_data(data_dir, n=8)
    args = joptions.parse_args_and_arch(joptions.get_training_parser(), [
        data_dir, "--task", "translation", "-s", "en", "-t", "de", *LC_ARCH, "--max-tokens", "100"])
    src = JaxDictionary.load(os.path.join(data_dir, "dict.en.txt"))
    tgt = JaxDictionary.load(os.path.join(data_dir, "dict.de.txt"))
    model = registry.build_model(args, DummyTask(tgt, src))
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(5)))
    ckpt = os.path.join(root, "checkpoint.pt")
    save_state(ckpt, {"args": vars(args), "model": variables["params"], "model_state": variables["state"]})
    return root, data_dir, ckpt


def test_lightconv_gives_no_alignments_as_in_jax(lightconv):
    root, data_dir, ckpt = lightconv
    argv = [data_dir, "--task", "translation", "-s", "en", "-t", "de", "--path", ckpt, "--beam", "3",
            "--max-len-b", "8", "--gen-subset", "test", "--max-sentences", "4", "--cpu", "--unkpen", "-5",
            "--print-alignment", "--replace-unk"]
    got, want, tscorer, jscorer = _run_both(root, argv, "lc")
    _compare(got, want)
    assert "A" not in got and len(got["H"]) == 4
    assert "<unk>" in " ".join(r[0][1] for r in got["H"].values())
    assert tscorer.result_string() == jscorer.result_string()


def test_replace_unk_helpers_match_jax(tmp_path):
    from fbk_fairseq_st_tpu.utils import align_utils as jalign

    path = tmp_path / "dict.txt"
    path.write_text("haus house\nkatze cat\nbad\n", encoding="utf-8")
    for value in (None, True, str(path)):
        assert align_utils.load_align_dict(value) == jalign.load_align_dict(value)
    d = align_utils.load_align_dict(str(path))
    for alignment in (["0-0", "2-1", "1-2"], [(1, 0), (0, 1), (5, 2)], None):
        for hypo in ("<unk> a <unk>", "a b c", "<unk>"):
            assert (align_utils.replace_unk(hypo, "haus katze maus", alignment, d, "<unk>")
                    == jalign.replace_unk(hypo, "haus katze maus", alignment, d, "<unk>"))
