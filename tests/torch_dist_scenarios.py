"""What the ranks of ``tests/torch_dist.py`` run: the port's trainer and
ops on a mesh of gloo processes, from weights and batches the JAX side of
a test made. Imports torch and the port only (no JAX). Each function runs
on every rank of the world and returns something picklable (numpy)."""

import sys

import torch
import torch.distributed as dist

from fbk_fairseq_st_tpu_torch import models, options, tasks  # noqa: F401  (no_dropout patches what they import)
from fbk_fairseq_st_tpu_torch.data import Dictionary
from fbk_fairseq_st_tpu_torch.ops import core
from fbk_fairseq_st_tpu_torch.parallel.mesh import make_mesh


def dictionary(n: int) -> Dictionary:
    d = Dictionary()
    for i in range(n):
        d.add_symbol(f"tok{i}")
    d.finalize(padding_factor=1)
    return d


def _identity_dropout(x, *args, **kwargs):
    return x


def no_dropout() -> None:
    """Every dropout of the port the identity (the conv front end's floor
    of 0.1 cannot be turned off by the options), as the JAX side does."""
    original = core.dropout
    for mod in list(sys.modules.values()):
        if getattr(mod, "__name__", "").startswith("fbk_fairseq_st_tpu_torch") and \
                getattr(mod, "dropout", None) is original:
            mod.dropout = _identity_dropout


def _np(t):
    return t.detach().cpu().numpy().copy()


def build(argv, vocab, src_vocab=None):
    """(args, task, model, criterion) of the port on the CPU (a language
    model's task when ``argv`` names ``language_modeling``)."""
    from fbk_fairseq_st_tpu_torch.tasks import LanguageModelingTask, SpeechRecognitionTask, SpeechTranslationCTCTask

    args = options.parse_args_and_arch(options.get_training_parser(), argv)
    if args.task == "language_modeling":
        task = LanguageModelingTask(args, dictionary(vocab))
    elif src_vocab is None:
        task = SpeechRecognitionTask(args, dictionary(vocab))
    else:
        task = SpeechTranslationCTCTask(args, dictionary(vocab), dictionary(src_vocab))
    model = task.build_model(args, device="cpu")
    return args, task, model, task.build_criterion(args)


def train(argv, vocab, init_state, updates, ranks=None, model=1, dcn=1, src_vocab=None, resume_at=None,
          argv_extra=()):
    """The port's trainer on a mesh over ``ranks`` (all by default): the
    updates (each a list of microbatch samples) from ``init_state``; the
    logging outputs of each, the whole final state (the mesh's first rank),
    the bytes of this rank's parameters and optimiser state and the local
    shapes. With ``resume_at`` the trainer's whole state after that many
    updates goes into a new trainer, which takes the rest."""
    from fbk_fairseq_st_tpu_torch.train import Trainer

    no_dropout()
    mesh = make_mesh(model=model, dcn=dcn, ranks=ranks)
    if mesh is None:
        return None
    args, task, net, criterion = build(list(argv) + list(argv_extra), vocab, src_vocab)
    net.load_state_dict({k: torch.tensor(v) for k, v in init_state.items()}, strict=True)
    trainer = Trainer(args, task, net, criterion, mesh=mesh)
    logs = []
    for i, samples in enumerate(updates):
        if resume_at is not None and i == resume_at:
            state = trainer.state_for_checkpoint()
            shapes = {n: tuple(p.shape) for n, p in trainer.model.named_parameters()}
            args, task, net, criterion = build(list(argv) + list(argv_extra), vocab, src_vocab)
            trainer = Trainer(args, task, net, criterion, mesh=mesh)
            trainer.load_trainer_state(state)
            assert shapes == {n: tuple(p.shape) for n, p in trainer.model.named_parameters()}
        out = trainer.train_step(samples)
        logs.append({k: float(v) for k, v in out.items()})
    trainer.flush_logs()
    state = trainer.full_model_state()
    opt_bytes = sum(v.numel() * v.element_size() for st in trainer.optimizer.state.values() for v in st.values()
                    if isinstance(v, torch.Tensor) and v.dim() > 0)
    return dict(logs=logs, state={k: _np(v) for k, v in state.items()} if trainer.is_first_rank else None,
                param_bytes=sum(p.numel() * p.element_size() for p in trainer.params), opt_bytes=opt_bytes,
                shapes={n: tuple(p.shape) for n, p in trainer.model.named_parameters()}, layout=trainer.layout)


def logits(argv, vocab, init_state, sample, ranks=None, model=1, criterion=None):
    """The decoder's logits (gathered whole) and the criterion's loss and
    gradients of one batch under tensor parallelism (no update)."""
    from fbk_fairseq_st_tpu_torch.train import Trainer

    no_dropout()
    mesh = make_mesh(model=model, ranks=ranks)
    if mesh is None:
        return None
    extra = [] if criterion is None else ["--criterion", criterion]
    args, task, net, crit = build(list(argv) + extra, vocab)
    net.load_state_dict({k: torch.tensor(v) for k, v in init_state.items()}, strict=True)
    trainer = Trainer(args, task, net, crit, mesh=mesh)
    batch = trainer._device_batch(trainer._local_sample(sample))
    loss, size, _ = crit(trainer.model, batch, core.make_generators(1, "cpu"), training=True)
    loss.backward()
    grads = {n: _np(trainer._whole(n, p.grad)) for n, p in zip(trainer.param_names(), trainer.params)}
    return dict(loss=float(loss), sample_size=float(size), grads=grads if trainer.is_first_rank else None)


def ring(cases, ranks):
    """For each (q, k, v, bias, scale, causal) of whole (BH, T, D) arrays:
    the ring's output and the gradients of sum(o * w) + sum(o^2) in q, k
    and v, over the ranks of ``ranks`` (each holding its time chunk, the
    whole gathered for the answer)."""
    from fbk_fairseq_st_tpu_torch.ops.ring_attention import RingGroup, _RingAttention
    from fbk_fairseq_st_tpu_torch.parallel.collectives import all_gather_tensor, chunk_of

    mesh = make_mesh(model=len(ranks), ranks=ranks)
    if mesh is None:
        return None
    group = mesh.group("model")
    rg = RingGroup(group)
    out = []
    for q, k, v, bias, w, scale, causal in cases:
        q, k, v = (torch.tensor(chunk_of(torch.tensor(x), 1, group).numpy(), requires_grad=True) for x in (q, k, v))
        o = _RingAttention.apply(q, k, v, chunk_of(torch.tensor(bias), 1, group), scale, causal, 0.0, 0, rg)
        wl = chunk_of(torch.tensor(w), 1, group)
        ((o * wl).sum() + (o ** 2).sum()).backward()
        out.append({name: _np(all_gather_tensor(t, 1, group)) for name, t in
                    (("out", o), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad))})
    return out


def mha_ring(cfg, state, x, kpm, ranks):
    """``MultiheadAttention`` with its ring set over ``ranks`` against its
    own dense route, causal and not; outputs and input gradients."""
    from fbk_fairseq_st_tpu_torch.ops.attention import MHAConfig, MultiheadAttention
    from fbk_fairseq_st_tpu_torch.ops.ring_attention import RingGroup

    mesh = make_mesh(model=len(ranks), ranks=ranks)
    if mesh is None:
        return None
    attn = MultiheadAttention(MHAConfig(*cfg))
    attn.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
    out = {}
    for mask in (None, "causal"):
        for ring in (False, True):
            attn.ring = RingGroup(mesh.group("model")) if ring else None
            xt = torch.tensor(x, requires_grad=True)
            o, _, _ = attn(xt, key_padding_mask=torch.tensor(kpm), attn_mask=mask)
            (o ** 2).sum().backward()
            out[(mask, ring)] = (_np(o), _np(xt.grad))
    return out


def vocab_parallel_ce(logits, target, w, ranks):
    """sum(w * CE) of (rows, T, V) logits split on V over ``ranks``, its
    gradient in the logits (gathered whole), and the plain form's value."""
    from fbk_fairseq_st_tpu_torch.parallel.collectives import all_gather_tensor, chunk_of
    from fbk_fairseq_st_tpu_torch.parallel.vocab_parallel import (
        vocab_parallel_cross_entropy,
        vocab_parallel_cross_entropy_sharded,
    )

    mesh = make_mesh(model=len(ranks), ranks=ranks)
    if mesh is None:
        return None
    group = mesh.group("model")
    x = torch.tensor(chunk_of(torch.tensor(logits), -1, group).numpy(), requires_grad=True)
    loss = (vocab_parallel_cross_entropy_sharded(x, torch.tensor(target), group) * torch.tensor(w)).sum()
    loss.backward()
    plain = (vocab_parallel_cross_entropy(torch.tensor(logits), torch.tensor(target)) * torch.tensor(w)).sum()
    return dict(loss=float(loss), grad=_np(all_gather_tensor(x.grad, -1, group)), plain=float(plain))


def local_sgd_linear(bmuf, params, batches, lr, ranks):
    """``optim/local_sgd.py`` over the ranks: a linear least-squares model
    (w, b) stepped by the port's Adam on each rank's replica batch, the
    block sync after every update's ``after_update``; the replicas' params
    after each update (gathered) and the optimiser state's bytes."""
    import argparse

    from fbk_fairseq_st_tpu_torch.optim import build_optimizer, set_lr
    from fbk_fairseq_st_tpu_torch.optim.local_sgd import LocalSGDBMUF

    mesh = make_mesh(ranks=ranks)
    if mesh is None:
        return None
    args = argparse.Namespace(optimizer="adam", adam_betas="(0.9, 0.999)", adam_eps=1e-8, weight_decay=0.0,
                              **bmuf)
    w = torch.nn.Parameter(torch.tensor(params["w"]))
    b = torch.nn.Parameter(torch.tensor(params["b"]))
    opt = build_optimizer(args, [w, b])
    runner = LocalSGDBMUF(args, mesh.group("batch"))
    r = mesh.batch_rank
    history = []
    for step, batch in enumerate(batches):
        x, y = torch.tensor(batch["x"][r]), torch.tensor(batch["y"][r])
        opt.zero_grad()
        ((x @ w + b - y) ** 2).mean().backward()
        set_lr(opt, lr)
        opt.step()
        runner.after_update([w, b], opt, step + 1)
        history.append((_np(w), _np(b)))
    return history


def bmuf_trainer(argv, vocab, init_state, updates, ranks):
    """The trainer with ``--use-bmuf`` against this rank's own update on
    its rows by a trainer without a mesh: equal before the first sync; the
    parameters after each update."""
    from fbk_fairseq_st_tpu_torch.train import Trainer

    no_dropout()
    mesh = make_mesh(ranks=ranks)
    if mesh is None:
        return None
    args, task, net, crit = build(argv, vocab)
    net.load_state_dict({k: torch.tensor(v) for k, v in init_state.items()}, strict=True)
    trainer = Trainer(args, task, net, crit, mesh=mesh)
    # a mesh of this rank alone for the trainer without one (a trainer
    # left to itself in an initialised world makes a mesh over it)
    alone = [make_mesh(ranks=[r]) for r in ranks]
    sargs, stask, snet, scrit = build([a for a in argv if a != "--use-bmuf"], vocab)
    snet.load_state_dict({k: torch.tensor(v) for k, v in init_state.items()}, strict=True)
    solo = Trainer(sargs, stask, snet, scrit, mesh=alone[ranks.index(dist.get_rank())])
    out = []
    for samples in updates:
        trainer.train_step(samples)
        solo.train_step([trainer._local_sample(s) for s in samples])
        out.append(({n: _np(p) for n, p in zip(trainer.param_names(), trainer.params)},
                    {n: _np(p) for n, p in zip(solo.param_names(), solo.params)}))
    trainer.flush_logs()
    return out

