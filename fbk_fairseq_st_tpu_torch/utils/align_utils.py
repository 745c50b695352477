"""--replace-unk post-processing (reference fairseq/utils.py:108-160).

The port's copy of ``fbk_fairseq_st_tpu/utils/align_utils.py``.

``load_align_dict`` turns the --replace-unk value into an alignment
dictionary (empty = copy the aligned source token); ``post_process_prediction``
renders a hypothesis string, substitutes <unk> outputs with the source token
their attention aligned to (optionally mapped through the dictionary built by
preprocess --alignfile), and re-encodes the string so BLEU is scored on the
post-processed tokens — exactly the reference generate pipeline.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence


def load_align_dict(replace_unk) -> Optional[Dict[str, str]]:
    """Reference fairseq/utils.py:108-121. None -> disabled; a file path ->
    'src_word tgt_word' lines; any other truthy value -> empty dict (unks
    are replaced by the raw aligned source token)."""
    if replace_unk is None:
        return None
    if isinstance(replace_unk, str) and len(replace_unk) > 0:
        align_dict = {}
        with open(replace_unk, encoding="utf-8") as f:
            for line in f:
                cols = line.split()
                if len(cols) >= 2:
                    align_dict[cols[0]] = cols[1]
        return align_dict
    return {}


def _alignment_src_positions(alignment) -> Optional[List[int]]:
    """Normalize an alignment to src position per target step. Accepts the
    'src-tgt' string pairs attach_alignments produces or (src, tgt) tuples."""
    if alignment is None:
        return None
    out = []
    for item in alignment:
        if isinstance(item, str):
            s, _ = item.split("-")
        else:
            s = item[0]
        out.append(int(s))
    return out


def replace_unk(
    hypo_str: str,
    src_str: str,
    alignment,
    align_dict: Dict[str, str],
    unk: str,
) -> str:
    """Reference fairseq/utils.py:124-139: substitute every unk output token
    with the source token at its attention-aligned position (mapped through
    align_dict when the preprocess --alignfile dictionary knows it)."""
    src_positions = _alignment_src_positions(alignment)
    hypo_tokens = hypo_str.split()
    # <eos> appended so an alignment pointing one past the source copies
    # nothing meaningful rather than crashing (reference behavior)
    src_tokens = src_str.split() + ["<eos>"]
    for i, ht in enumerate(hypo_tokens):
        if ht == unk and src_positions is not None and i < len(src_positions):
            src_pos = src_positions[i]
            if 0 <= src_pos < len(src_tokens):
                src_token = src_tokens[src_pos]
                hypo_tokens[i] = align_dict.get(src_token, src_token)
    return " ".join(hypo_tokens)


def post_process_prediction(
    hypo_tokens,
    src_str: str,
    alignment,
    align_dict: Optional[Dict[str, str]],
    tgt_dict,
    remove_bpe: Optional[str] = None,
    extra_symbols_to_ignore: Optional[Sequence[int]] = None,
):
    """Reference fairseq/utils.py:142-160. Returns (hypo_tokens, hypo_str,
    alignment); when unk replacement or BPE removal changed the string, the
    token ids are re-encoded from it so scoring sees the processed words."""
    hypo_str = tgt_dict.string(
        hypo_tokens, remove_bpe, extra_symbols_to_ignore=extra_symbols_to_ignore
    )
    if align_dict is not None:
        hypo_str = replace_unk(
            hypo_str, src_str, alignment, align_dict, tgt_dict.unk_string()
        )
    if align_dict is not None or remove_bpe is not None:
        import numpy as np

        hypo_tokens = np.asarray(
            tgt_dict.encode_line(hypo_str, add_if_not_exist=True)
        )
    return hypo_tokens, hypo_str, alignment
