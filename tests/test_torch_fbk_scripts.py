"""PyTorch port, the FBK papers' data and evaluation scripts: each of the
port's eight standard-library scripts against JAX's on the same files, with
the same printed lines and the same written files, byte for byte.

The inputs are made from a numpy seed: a MuST-SHE-format definitions TSV
(ID, CATEGORY, GENDER, GENDERTERMS), POS and agreement definitions, two
systems' outputs that hold correct, wrong, both or neither forms of each
term, an NE/terminology IOB reference and its hypotheses, two IOB streams
over differently tokenized text, and a MuST-C segmentation (yaml) with its
texts, fast_align links and an automatic resegmentation. The aggregators
run with both bundled config files (the port's copies, which must equal
JAX's), and the resegmentation with ``yaml`` and with the fallback parser
(``yaml`` made unimportable)."""

import importlib
import os
import sys

import numpy as np
import pytest

JAX_SCRIPTS = "fbk_fairseq_st_tpu.scripts"
PORT_SCRIPTS = "fbk_fairseq_st_tpu_torch.scripts"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = [f"w{i}" for i in range(30)]
TERMS = [("amico", "amica"), ("stanco", "stanca"), ("nato", "nata"), ("il", "la"), ("bravo", "brava"),
         ("solo", "sola"), ("pronto", "pronta")]
POS = ["noun", "adj", "verb", "art/prep", "adj", "pronoun", "adj-determiner"]
CATEGORIES = ["1F", "1M", "2F", "2M", "3F", "4M"]


def _hypothesis(rng, terms):
    words = list(rng.choice(WORDS, size=rng.randint(3, 9)))
    for correct, wrong in terms:
        pick = rng.randint(4)
        words += {0: [correct], 1: [wrong], 2: [correct, wrong], 3: []}[pick]
    rng.shuffle(words)
    return " ".join(words) + "\n"


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("fbk_scripts")
    rng = np.random.RandomState(0)
    n = 12
    rows, pos_rows, agr_rows, chosen = [], [], [], []
    for i in range(n):
        idx = sorted(rng.choice(len(TERMS), size=rng.randint(1, 4), replace=False))
        terms = [TERMS[j] for j in idx]
        chosen.append(terms)
        rows.append(f"s{i}\t{CATEGORIES[i % len(CATEGORIES)]}\t{'She' if i % 2 else 'He'}\t"
                    + ";".join(f"{c} {w}" for c, w in terms))
        pos_rows.append(f"s{i}\t" + ";".join(POS[j] for j in idx))
        agr_rows.append(f"s{i}\t{'chain' if i % 3 else 'pair'}\t" + ";".join(f"{c} {w}" for c, w in terms)
                        + "\t" + ";".join(str(j) for j in idx))
    (root / "mustshe.tsv").write_text("ID\tCATEGORY\tGENDER\tGENDERTERMS\n" + "\n".join(rows) + "\n")
    (root / "pos.tsv").write_text("ID\tPOS\n" + "\n".join(pos_rows) + "\n")
    (root / "agr.tsv").write_text("ID\tAGR_KIND\tAGR_TERMS\tAGR_IDS\n" + "\n".join(agr_rows) + "\n")
    for system in ("sysA", "sysB"):
        (root / f"hyp.{system}").write_text("".join(_hypothesis(rng, t) for t in chosen))

    # NE / terminology: IOB reference, hypotheses, and two IOB streams
    ref, hyps, ner, term = [], [], [], []
    for i in range(6):
        toks = list(rng.choice(WORDS, size=6))
        tags = ["O"] * 6
        tags[1], tags[2] = "B-PER", "I-PER"
        tags[4] = ["B-ORG", "B-TERM"][i % 2]
        ref.append("".join(f"{k + 1}\t{t}\t{g}\n" for k, (t, g) in enumerate(zip(toks, tags))) + "\n")
        hyp = list(toks) if i % 3 else [t.upper() if k == 1 else t for k, t in enumerate(toks)]
        hyps.append(" ".join(hyp[: 6 - i % 2]) + "\n")
        ner_tags = ["O", "B-PER", "I-PER", "O", "B-LOC", "O"]
        ner.append("".join(f"{k + 1}\t{t}\t{g}\n" for k, (t, g) in enumerate(zip(toks, ner_tags))) + "\n")
        if i % 2:  # the terminology stream splits token 3 in two
            t_toks = toks[:3] + [toks[3][:1], toks[3][1:]] + toks[4:]
            t_tags = ["O", "O", "O", "B-TERM", "I-TERM", "O", "O"]
        else:
            t_toks, t_tags = toks, ["O", "O", "O", "O", "B-TERM", "O"]
        term.append("".join(f"{k + 1}\t{t}\t{g}\n" for k, (t, g) in enumerate(zip(t_toks, t_tags))) + "\n")
    (root / "ne_ref.iob").write_text("".join(ref))
    (root / "ne_hyp.txt").write_text("".join(hyps))
    (root / "ner.iob").write_text("".join(ner))
    (root / "term.iob").write_text("".join(term))

    # MuST-C segmentation: 5 segments on two wavs, and a resegmentation
    segs, new, en, de, links = [], [], [], [], []
    offset = {"a.wav": 0.0, "b.wav": 0.0}
    for i in range(5):
        wav = "a.wav" if i < 3 else "b.wav"
        dur = round(float(rng.uniform(2, 6)), 2)
        segs.append(f"- {{duration: {dur}, offset: {offset[wav]}, wav: {wav}}}")
        n_en, n_de = rng.randint(4, 10), rng.randint(4, 10)
        en.append(" ".join(f"e{i}_{k}" for k in range(n_en)))
        de.append(" ".join(f"d{i}_{k}" for k in range(n_de)))
        links.append(" ".join(f"{k}-{min(n_de - 1, int(k * n_de / n_en) + (7 if k == 0 and i == 1 else 0))}"
                              for k in range(n_en)))
        offset[wav] = round(offset[wav] + dur + 0.5, 2)
    for wav, end in offset.items():
        cut = 0.0
        while cut < end:
            dur = round(float(rng.uniform(1.5, 4)), 2)
            new.append(f"- {{duration: {dur}, offset: {cut}, wav: {wav}}}")
            cut = round(cut + dur, 2)
    (root / "orig.yaml").write_text("\n".join(segs) + "\n")
    (root / "new.yaml").write_text("\n".join(new) + "\n")
    (root / "orig.en").write_text("\n".join(en) + "\n")
    (root / "orig.de").write_text("\n".join(de) + "\n")
    (root / "orig.align").write_text("\n".join(links) + "\n")
    return root


def _run(package, script, argv, capsys):
    module = importlib.import_module(f"{package}.{script}")
    module.cli_main(argv)
    return capsys.readouterr().out


def _same_run(script, argv_of, tmp_path, capsys, outputs=()):
    """Both scripts on the same inputs, each writing into its own
    directory: the printed lines, and each written file, byte for byte."""
    results = {}
    for side, package in (("jax", JAX_SCRIPTS), ("port", PORT_SCRIPTS)):
        out_dir = tmp_path / side
        out_dir.mkdir()
        stdout = _run(package, script, argv_of(out_dir), capsys)
        results[side] = stdout, {name: (out_dir / name).read_bytes() for name in outputs}
    assert results["port"] == results["jax"]
    return results["port"]


def test_mustshe_acc_matches_jax(inputs, tmp_path, capsys):
    stdout, files = _same_run(
        "eval.mustshe_acc", lambda d: ["--input", str(inputs / "hyp.sysA"), "--tsv-definition",
                                       str(inputs / "mustshe.tsv"), "--sentence-acc", str(d / "sent.tsv"),
                                       "--debug"], tmp_path, capsys, ["sent.tsv"])
    assert "Global" in stdout and len(files["sent.tsv"].splitlines()) == 13


def _fulltable(inputs, out_dir, capsys, package):
    _run(package, "eval.mustshe_acc_fulltable",
         ["--input-prefix", str(inputs / "hyp."), "--tsv-definition", str(inputs / "mustshe.tsv"),
          "--pos-definition", str(inputs / "pos.tsv"), "--output", str(out_dir / "full.tsv")], capsys)


def _agr_fulltable(inputs, out_dir, capsys, package):
    _run(package, "eval.mustshe_agr_fulltable",
         ["--input-prefix", str(inputs / "hyp."), "--tsv-definition", str(inputs / "mustshe.tsv"),
          "--agr-definition", str(inputs / "agr.tsv"), "--output", str(out_dir / "agr.tsv")], capsys)


@pytest.mark.parametrize("table", ["one-term", "full"])
def test_mustshe_acc_fulltable_matches_jax(inputs, tmp_path, capsys, table):
    """One term: the port's table is JAX's, byte for byte. More terms:
    JAX's raises ``KeyError`` (ROADMAP Queue C); the port's rows hold JAX's
    ``sentence_level_scores`` of each system, in JAX's column order."""
    from fbk_fairseq_st_tpu.scripts.eval import mustshe_acc_fulltable as jfull

    if table == "one-term":
        tsv = tmp_path / "one.tsv"
        tsv.write_text("".join((inputs / "mustshe.tsv").read_text().splitlines(True)[:2]).split(";")[0] + "\n")
        prefix = tmp_path / "one_hyp."
        for system in ("sysA", "sysB"):
            (tmp_path / f"one_hyp.{system}").write_text((inputs / f"hyp.{system}").read_text().splitlines()[0])
        _same_run("eval.mustshe_acc_fulltable",
                  lambda d: ["--input-prefix", str(prefix), "--tsv-definition", str(tsv), "--pos-definition",
                             str(inputs / "pos.tsv"), "--output", str(d / "full.tsv")], tmp_path, capsys, ["full.tsv"])
        return
    with pytest.raises(KeyError):
        _fulltable(inputs, tmp_path, capsys, JAX_SCRIPTS)
    _fulltable(inputs, tmp_path, capsys, PORT_SCRIPTS)
    pos = jfull.read_pos_definition(str(inputs / "pos.tsv"))
    systems = {s: jfull.sentence_level_scores(str(inputs / f"hyp.{s}"), str(inputs / "mustshe.tsv"), pos)
               for s in ("sysA", "sysB")}
    lines = (tmp_path / "full.tsv").read_text().splitlines()
    base = ["sentence_id", "correct", "wrong", "speaker_gender", "category", "pos", "class", "gender"]
    cols = [f"hyp.{s}_{h}" for s in systems for h in ("found", "found_correct", "found_wrong")]
    assert lines[0].split("\t") == base + cols
    assert len(lines) == 1 + len(systems["sysA"]) > 13
    for i, line in enumerate(lines[1:]):
        want = [str(systems["sysA"][i][h]) for h in base]
        want += [str(systems[s][i][h]) for s in systems for h in ("found", "found_correct", "found_wrong")]
        assert line.split("\t") == want


def test_mustshe_agr_fulltable_matches_jax(inputs, tmp_path, capsys):
    _, files = _same_run("eval.mustshe_agr_fulltable",
                         lambda d: ["--input-prefix", str(inputs / "hyp."), "--tsv-definition",
                                    str(inputs / "mustshe.tsv"), "--agr-definition", str(inputs / "agr.tsv"),
                                    "--output", str(d / "agr.tsv")], tmp_path, capsys, ["agr.tsv"])
    assert len(files["agr.tsv"].splitlines()) == 13


@pytest.mark.parametrize("config", ["word-level", "agr-level"])
def test_aggregators_match_jax(inputs, tmp_path, capsys, config):
    """``accuracy_from_fulltable`` over the word-level table and
    ``agreement_from_fulltable`` over the agreement table, each with its
    bundled config: the port's config files are JAX's."""
    name = f"config.{config}.json"
    port_config = os.path.join(REPO, "fbk_fairseq_st_tpu_torch", "scripts", "eval", "config_files", name)
    jax_config = os.path.join(REPO, "fbk_fairseq_st_tpu", "scripts", "eval", "config_files", name)
    with open(port_config, "rb") as a, open(jax_config, "rb") as b:
        assert a.read() == b.read()
    tables = tmp_path / "tables"
    tables.mkdir()
    if config == "word-level":
        _fulltable(inputs, tables, capsys, PORT_SCRIPTS)  # JAX's raises on this table (see above)
        script, table = "eval.accuracy_from_fulltable", tables / "full.tsv"
    else:
        _agr_fulltable(inputs, tables, capsys, JAX_SCRIPTS)
        script, table = "eval.agreement_from_fulltable", tables / "agr.tsv"
    _, files = _same_run(script, lambda d: ["--fulltable", str(table), "--config", port_config,
                                            "--output", str(d / "metrics.tsv")], tmp_path, capsys, ["metrics.tsv"])
    assert len(files["metrics.tsv"].splitlines()) >= 3


def test_ne_terms_accuracy_matches_jax(inputs, tmp_path, capsys):
    stdout, _ = _same_run("eval.ne_terms_accuracy",
                          lambda d: ["--input", str(inputs / "ne_hyp.txt"), "--ne-reference",
                                     str(inputs / "ne_ref.iob")], tmp_path, capsys)
    assert "== Full-entity scores ==" in stdout and "\nPER\t" in stdout


def test_combine_ne_terms_matches_jax(inputs, tmp_path, capsys):
    stdout, _ = _same_run("combine_ne_terms", lambda d: [str(inputs / "ner.iob"), str(inputs / "term.iob")],
                          tmp_path, capsys)
    assert "B-TERM" in stdout and "B-PER" in stdout


@pytest.mark.parametrize("parser", ["yaml", "fallback"])
@pytest.mark.parametrize("aligned", [False, True])
def test_resegment_matches_jax(inputs, tmp_path, capsys, monkeypatch, parser, aligned):
    """Both texts resegmented alike, with and without fast_align links,
    and the segmentations read by ``yaml`` or by the fallback parser."""
    if parser == "fallback":
        monkeypatch.setitem(sys.modules, "yaml", None)
    extra = ["--text-alignments", str(inputs / "orig.align")] if aligned else []
    _, files = _same_run("resegment_data_mustc",
                         lambda d: ["--orig-yaml", str(inputs / "orig.yaml"), "--orig-text", str(inputs / "orig.en"),
                                    str(inputs / "orig.de"), "--new-yaml", str(inputs / "new.yaml"), "--output",
                                    str(d / "new.en"), str(d / "new.de"), *extra],
                         tmp_path, capsys, ["new.en", "new.de"])
    n_new = len((inputs / "new.yaml").read_text().splitlines())
    assert len(files["new.de"].decode().splitlines()) == n_new
    assert files["new.en"].split() == (inputs / "orig.en").read_bytes().split()
