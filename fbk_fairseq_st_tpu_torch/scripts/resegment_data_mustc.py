#!/usr/bin/python3
"""Re-align MuST-C targets to an automatic audio segmentation
(INTERSPEECH 2020 data prep).

Counterpart of examples/speech_recognition/scripts/resegment_data_mustc.py:
the original corpus has (audio segment, transcript, translation) triples;
an automatic segmenter produces different audio boundaries. For each new
segment, the overlapping original segments are found and the target text is
cut proportionally to the time overlap — a word-timing interpolation that
assumes words are uniformly distributed over their segment (the reference
additionally uses fast_align word alignments to snap cut points; this
implementation interpolates on both source and target sides and documents
that simplification).

Inputs: original segments yaml (list of {offset, duration, wav}), original
transcripts/translations (one per segment), new segments yaml. Outputs the
resegmented transcripts/translations (one per new segment).

The port's copy of ``fbk_fairseq_st_tpu/scripts/resegment_data_mustc.py``: the standard
library only, the same printed lines and written files, byte for byte.

    python -m fbk_fairseq_st_tpu_torch.scripts.resegment_data_mustc --orig-yaml O.yaml --orig-text O.en O.de --new-yaml N.yaml --output N.en N.de
"""

from __future__ import annotations

import argparse


def _load_yaml(path):
    try:
        import yaml

        with open(path) as f:
            return yaml.safe_load(f)
    except ImportError:
        # minimal parser for the MuST-C '- {duration: d, offset: o, wav: w}'
        segs = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line.startswith("- {"):
                    continue
                d = {}
                for kv in line[3:-1].split(","):
                    k, v = kv.split(":", 1)
                    d[k.strip()] = v.strip()
                segs.append(
                    {
                        "offset": float(d["offset"]),
                        "duration": float(d["duration"]),
                        "wav": d.get("wav", ""),
                    }
                )
        return segs


def _interval(seg):
    return float(seg["offset"]), float(seg["offset"]) + float(seg["duration"])


def _cut_words(words, start_frac: float, end_frac: float):
    n = len(words)
    lo = int(round(start_frac * n))
    hi = int(round(end_frac * n))
    return words[lo:hi]


def _snap_target_cut(aligns, src_lo: int, src_hi: int, n_tgt: int):
    """Map a source word span to a target span via word alignments,
    skipping isolated far-away links (the reference's >5-distance outlier
    rule, resegment_data_mustc.py:52-68 / :94-110). aligns: dict
    src_idx -> tgt_idx."""
    linked = sorted(
        aligns[i] for i in range(src_lo, src_hi) if i in aligns
    )
    if not linked:
        return None
    lo = linked[0]
    for i, idx in enumerate(linked):
        if i + 1 < len(linked) and linked[i + 1] - idx > 5:
            continue  # isolated early link: skip it
        lo = idx
        break
    hi = linked[-1]
    for i in range(len(linked) - 1, -1, -1):
        idx = linked[i]
        if i > 0 and idx - linked[i - 1] > 5:
            continue  # isolated late link
        hi = idx
        break
    return max(0, min(lo, n_tgt - 1)), min(hi + 1, n_tgt)


def resegment(orig_segments, texts, new_segments, src_texts=None,
              text_aligns=None):
    """For each new segment, concatenate the cuts of every overlapping
    original segment's text. Cut points are proportional to time overlap
    on the source side; when fast_align word alignments are provided
    (``text_aligns``, one per original segment), the target cut points are
    snapped to the aligned target words (the reference's fast_align
    snapping) instead of cutting the target proportionally."""
    out = []
    for new in new_segments:
        ns, ne = _interval(new)
        pieces = []
        for idx, (seg, text) in enumerate(zip(orig_segments, texts)):
            if seg.get("wav") != new.get("wav"):
                continue
            os_, oe = _interval(seg)
            lo = max(ns, os_)
            hi = min(ne, oe)
            if hi <= lo:
                continue
            dur = max(oe - os_, 1e-6)
            start_frac = (lo - os_) / dur
            end_frac = (hi - os_) / dur
            words = text.split()
            if text_aligns is not None and src_texts is not None:
                src_words = src_texts[idx].split()
                n_src = max(len(src_words), 1)
                s_lo = int(round(start_frac * n_src))
                s_hi = int(round(end_frac * n_src))
                span = _snap_target_cut(
                    text_aligns[idx], s_lo, s_hi, len(words)
                )
                if span is None:
                    # few/unalignable words: proportional fallback
                    # (reference "brutal alignment" branch)
                    pieces.extend(_cut_words(words, start_frac, end_frac))
                else:
                    pieces.extend(words[span[0]: span[1]])
            else:
                pieces.extend(_cut_words(words, start_frac, end_frac))
        out.append(" ".join(pieces))
    return out


def load_text_alignments(path):
    """fast_align output: one 'i-j i-j ...' line per sentence ->
    list of {src_idx: tgt_idx} (last link wins, as in the reference's
    dict construction)."""
    aligns = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            d = {}
            for pair in line.split():
                i, j = pair.split("-")
                d[int(i)] = int(j)
            aligns.append(d)
    return aligns


def cli_main(input_args=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--orig-yaml", required=True,
                        help="original segments yaml")
    parser.add_argument("--orig-text", required=True, nargs="+",
                        help="original text file(s) aligned with --orig-yaml "
                        "(e.g. transcripts and translations)")
    parser.add_argument("--new-yaml", required=True,
                        help="automatic segmentation yaml")
    parser.add_argument("--output", required=True, nargs="+",
                        help="output file(s), one per --orig-text")
    parser.add_argument("--text-alignments", default=None,
                        help="fast_align output over "
                             "(first --orig-text, other --orig-text) pairs; "
                             "snaps the non-first texts' cut points to the "
                             "aligned words")
    args = parser.parse_args(input_args)
    assert len(args.orig_text) == len(args.output)

    orig_segments = _load_yaml(args.orig_yaml)
    new_segments = _load_yaml(args.new_yaml)
    aligns = (
        load_text_alignments(args.text_alignments)
        if args.text_alignments else None
    )
    src_texts = None
    for n, (text_path, out_path) in enumerate(
        zip(args.orig_text, args.output)
    ):
        with open(text_path, encoding="utf-8") as f:
            texts = [line.rstrip("\n") for line in f]
        assert len(texts) == len(orig_segments), (
            f"{text_path}: {len(texts)} lines vs {len(orig_segments)} segments"
        )
        if n == 0:
            src_texts = texts  # alignments are source->target
            resegmented = resegment(orig_segments, texts, new_segments)
        else:
            resegmented = resegment(
                orig_segments, texts, new_segments,
                src_texts=src_texts, text_aligns=aligns,
            )
        with open(out_path, "w", encoding="utf-8") as f:
            f.write("\n".join(resegmented) + "\n")


if __name__ == "__main__":
    cli_main()
