"""PyTorch port, multi-GPU slice: tensor parallelism, sequence parallelism,
ring attention inside a train step, and the vocabulary-parallel cross
entropy, over four gloo processes on the CPU, against JAX.

The reference is JAX's unsharded Trainer on the global batch (its own
tests/test_tensor_parallel_step.py and tests/test_sequence_parallel.py
hold its sharded steps equal to it), the same three updates as
tests/test_torch_distributed.py (shared by the session). The port's
scenarios run in one spawn of four ranks: TP 2 on two of them, DP 2 x
TP 2 on all four, each with sequence parallelism off and on, and TP 2 with
ring attention. The batches' encoder length (10 after the front end) and
target length (8) split over the model ranks, so sequence parallelism and
the ring engage in every layer. fp32; tolerances as in
tests/test_torch_distributed.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from fbk_fairseq_st_tpu.parallel.vocab_parallel import (
    vocab_parallel_cross_entropy,
    vocab_parallel_cross_entropy_shardmap,
)

from .test_torch_distributed import LSCE_ARGV, LSCE_UPDATES, VOCAB, ZERO_GRADIENT, assert_matches, jax_lsce
from .torch_dist import run_ranks
from .torch_shared import session_root, shared

TP_CASES = {
    "tp2": dict(ranks=[0, 1], model=2),
    "tp2_sp": dict(ranks=[0, 1], model=2, argv_extra=["--sequence-parallel"]),
    "dp2_tp2": dict(model=2),
    "dp2_tp2_sp": dict(model=2, argv_extra=["--sequence-parallel"]),
    "tp2_ring": dict(ranks=[0, 1], model=2, argv_extra=["--ring-attention"]),
}
_LSCE = LSCE_ARGV.index("--criterion")
VP_ARGV = LSCE_ARGV[:_LSCE] + ["--criterion", "vocab_parallel_cross_entropy"] + LSCE_ARGV[_LSCE + 4:]


def _ce_inputs(seed=0, rows=6, t=5, v=12):
    rng = np.random.RandomState(seed)
    return rng.randn(rows, t, v).astype(np.float32), rng.randint(0, v, size=(rows, t)), rng.randn(rows, t)


def _make(directory, lsce):
    logits, target, w = _ce_inputs()
    scenarios = [(name, dict(fn="train", argv=LSCE_ARGV, vocab=VOCAB, init_state=lsce["start"], updates=LSCE_UPDATES,
                             **case)) for name, case in TP_CASES.items()]
    scenarios += [
        ("dcn2_fsdp", dict(fn="train", argv=LSCE_ARGV, vocab=VOCAB, init_state=lsce["start"], updates=LSCE_UPDATES,
                           dcn=2, argv_extra=["--fsdp", "--fsdp-min-shard-size", "256", "--dcn-data-parallel", "2"])),
        ("vp_tp2", dict(fn="train", argv=VP_ARGV, vocab=VOCAB, init_state=lsce["start"], updates=LSCE_UPDATES,
                        ranks=[0, 1], model=2)),
        ("vp_one", dict(fn="train", argv=VP_ARGV, vocab=VOCAB, init_state=lsce["start"], updates=LSCE_UPDATES,
                        ranks=[2])),
        ("vp_fn", dict(fn="vocab_parallel_ce", logits=logits, target=target, w=w, ranks=[0, 1])),
    ]
    return run_ranks(4, scenarios, directory)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = session_root(tmp_path_factory)
    lsce = shared(root, "torch_dist_jax_lsce", jax_lsce)
    return lsce, shared(root, "torch_tensor_parallel", lambda directory: _make(directory, lsce))


@pytest.mark.parametrize("case", sorted(TP_CASES))
def test_split_steps_match_jax(runs, case):
    """Three updates of each layout equal JAX's unsharded steps: the loss,
    the counts, the gnorm (each split leaf's squares summed over its
    ranks), every parameter gathered whole, and the BatchNorm running
    stats; every rank logs the same."""
    lsce, ranks = runs
    out = [r for r in ranks[case] if r is not None]
    assert all(r["logs"] == out[0]["logs"] for r in out)
    assert_matches(out[0]["logs"], out[0]["state"], lsce)
    layout = out[0]["layout"]
    if case != "tp2_ring":
        assert layout["decoder.layers.0.self_attn.q_proj.weight"] == ("model", None)
        assert layout["decoder.layers.0.fc2.weight"] == (None, "model")
    assert layout["decoder.embed_tokens.weight"] == ("model", None)
    assert ("encoder.layers.0.self_attn.q_proj.weight" in layout) == (case != "tp2_ring")


def test_fsdp_inside_dcn_slices_matches_jax(runs):
    """--dcn-data-parallel 2 with --fsdp over four ranks (HSDP: the batch
    over dcn x data, each leaf's chunks over the 2 data ranks of a slice,
    replicated over dcn) equals JAX's unsharded steps."""
    lsce, ranks = runs
    out = ranks["dcn2_fsdp"]
    assert all(r["logs"] == out[0]["logs"] for r in out)
    assert_matches(out[0]["logs"], out[0]["state"], lsce)
    whole = sum(4 * v.size for k, v in lsce["start"].items() if "running_" not in k)
    split = [n for n, spec in out[0]["layout"].items() if spec.count("data") == 1 and "model" not in spec]
    assert split and len(split) == len(out[0]["layout"])
    for r in out:
        assert r["param_bytes"] == whole - sum(4 * lsce["start"][n].size // 2 for n in split)


def test_tensor_parallel_halves_the_split_leaves(runs):
    """Each model rank holds half of every split leaf: its parameter bytes
    are the whole model's less half of those leaves'."""
    lsce, ranks = runs
    whole = sum(4 * v.size for k, v in lsce["start"].items() if "running_" not in k)
    out = ranks["tp2"][0]
    split = sum(4 * lsce["start"][n].size for n in out["layout"])
    assert out["param_bytes"] == whole - split // 2


def test_vocab_parallel_cross_entropy_matches_jax(runs):
    """The split-vocabulary CE over two ranks and its gradient equal JAX's
    ``vocab_parallel_cross_entropy`` and its ``shard_map`` form on a
    2-device mesh (1e-5); the criterion ``vocab_parallel_cross_entropy`` at
    TP 2, whose logits stay split, trains as it does on one rank."""
    _, ranks = runs
    logits, target, w = _ce_inputs()

    def loss(x):
        return jnp.sum(vocab_parallel_cross_entropy(x, jnp.asarray(target)) * w)

    want, want_grad = jax.value_and_grad(loss)(jnp.asarray(logits))
    mesh = Mesh(np.array(jax.devices()[:2]), ("model",))
    sharded = vocab_parallel_cross_entropy_shardmap(jnp.asarray(logits), jnp.asarray(target), mesh)
    np.testing.assert_allclose(np.sum(np.asarray(sharded) * w), float(want), rtol=1e-5)
    for r in ranks["vp_fn"][:2]:
        np.testing.assert_allclose(r["loss"], float(want), rtol=1e-5)
        np.testing.assert_allclose(r["grad"], np.asarray(want_grad), rtol=0,
                                   atol=1e-5 * np.abs(want_grad).max())
        np.testing.assert_allclose(r["plain"], float(want), rtol=1e-5)
    one, tp = ranks["vp_one"][2], ranks["vp_tp2"][0]
    assert tp["layout"]["decoder.embed_tokens.weight"] == ("model", None)
    for a, b in zip(tp["logs"], one["logs"]):
        for key in ("loss", "sample_size", "gnorm"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-5, err_msg=key)
    lr_sum = runs[0]["lr_sum"]
    for name, value in one["state"].items():
        tol = 2 * lr_sum if ZERO_GRADIENT.match(name) else 1e-5 * max(np.abs(value).max(), 1.0)
        np.testing.assert_allclose(tp["state"][name], value, rtol=0, atol=tol, err_msg=name)


def test_sharding_rules_follow_jax():
    """``param_sharding`` and the row slice, without ranks (a mesh's shape
    and coordinates alone): the TP rules on the fork's names in torch's
    (out, in) layout, a dim that does not divide left whole, FSDP's
    ``data`` on the largest free dim of a leaf of at least the minimum
    size (JAX ``_fsdp_spec``; the first of equal dims here), sequence
    parallelism's eligibility, and each data rank's rows."""
    from fbk_fairseq_st_tpu_torch.parallel.mesh import (
        FSDP_MIN_SIZE, Mesh, local_row_range, param_sharding, seq_parallel_eligible)

    mesh = Mesh({"data": 2, "model": 2}, {"data": 1, "model": 0})
    shapes = {
        "decoder.layers.0.self_attn.q_proj.weight": (64, 64),
        "decoder.layers.0.self_attn.q_proj.bias": (64,),
        "decoder.layers.0.encoder_attn.out_proj.weight": (64, 64),
        "decoder.layers.0.encoder_attn.out_proj.bias": (64,),
        "encoder.layers.1.fc1.weight": (128, 64),
        "encoder.layers.1.fc2.weight": (64, 128),
        "decoder.embed_tokens.weight": (45, 64),  # 45 rows: no model split
        "decoder.output_projection.weight": (44, 64),
        "encoder.fc3.weight": (64, 96),
        "encoder.layers.1.final_layer_norm.weight": (64,),
    }
    tp = param_sharding(shapes, mesh, use_tp=True)
    assert tp["decoder.layers.0.self_attn.q_proj.weight"] == ("model", None)
    assert tp["decoder.layers.0.self_attn.q_proj.bias"] == ("model",)
    assert tp["decoder.layers.0.encoder_attn.out_proj.weight"] == (None, "model")
    assert tp["decoder.layers.0.encoder_attn.out_proj.bias"] == (None,)
    assert tp["encoder.layers.1.fc1.weight"] == ("model", None)
    assert tp["encoder.layers.1.fc2.weight"] == (None, "model")
    assert tp["decoder.embed_tokens.weight"] == (None, None)
    assert tp["decoder.output_projection.weight"] == ("model", None)
    assert tp["encoder.fc3.weight"] == (None, None)
    both = param_sharding(shapes, mesh, use_tp=True, use_fsdp=True, fsdp_min_size=2048)
    assert both["decoder.layers.0.self_attn.q_proj.weight"] == ("model", "data")
    assert both["encoder.layers.1.fc1.weight"] == ("model", "data")
    assert both["encoder.fc3.weight"] == (None, "data")  # 96 > 64
    assert both["decoder.embed_tokens.weight"] == (None, "data")  # 45 rows do not divide
    assert both["decoder.layers.0.self_attn.q_proj.bias"] == ("model",)  # under the minimum
    assert param_sharding(shapes, mesh, use_tp=True, tp_names=["encoder.layers.1.fc1.weight"])[
        "decoder.layers.0.self_attn.q_proj.weight"] == (None, None)
    assert FSDP_MIN_SIZE == 4096
    fsdp = param_sharding({"a": (64, 64), "b": (63, 64)}, mesh, use_fsdp=True)  # the default minimum
    assert fsdp == {"a": ("data", None), "b": (None, None)}
    assert seq_parallel_eligible(torch.zeros(2, 8, 4), 2) and not seq_parallel_eligible(torch.zeros(2, 7, 4), 2)
    assert not seq_parallel_eligible(torch.zeros(2, 1, 4), 1) and not seq_parallel_eligible(torch.zeros(8, 4), 2)
    assert local_row_range(mesh, 16) == (8, 16) and local_row_range(None, 16) == (0, 16)
    with pytest.raises(ValueError, match="does not split"):
        local_row_range(mesh, 9)
