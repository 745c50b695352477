"""Optimizers.

Counterpart of ``fbk_fairseq_st_tpu/optim/optimizers.py``. The JAX package
builds optax transforms that turn the gradients into an lr-free, unsigned
update ``u``, applied as ``p -= lr * u`` with the scheduler's lr; its
weight decay is coupled (``_with_weight_decay``: ``g += wd * p`` before the
statistics). Each optimiser here computes that same update:

  * ``torch.optim`` classes where their update is optax's, held against
    optax in ``tests/test_torch_optim.py``: Adam (``scale_by_adam``),
    Adadelta (``scale_by_adadelta``), Adamax (``scale_by_adamax``) and SGD
    (``trace``, plain and with ``nesterov=True`` for NAG);
  * small optimisers over ``torch._foreach_*`` ops where no class does:
    ``Adagrad`` (``scale_by_rss``: eps inside the root, and an update of 0
    where the sum of squares is 0), ``Adafactor`` (``scale_by_factored_rms``
    and ``clip_by_block_rms``, then an optional ``trace``) and ``Lamb``
    (``scale_by_adam``, the decay after it, then ``scale_by_trust_ratio``).

The trainer sets the lr of every group before each step (``set_lr``). The
JAX package wrote no kernel for any optimiser (XLA fuses the update), and
neither does the port.
"""

from __future__ import annotations

import ast

import torch


def _parse_betas(s) -> tuple:
    if isinstance(s, (tuple, list)):
        return tuple(s)
    return tuple(ast.literal_eval(s))


def _wd(args) -> float:
    return getattr(args, "weight_decay", 0.0) or 0.0


def _add_weight_decay(parser) -> None:
    parser.add_argument("--weight-decay", "--wd", default=0.0, type=float, metavar="WD", help="weight decay")


def _decayed(grads, params, wd):
    """g + wd * p (optax ``add_decayed_weights``), as new tensors."""
    return torch._foreach_add(grads, params, alpha=wd) if wd else list(grads)


class Adagrad(torch.optim.Optimizer):
    """optax ``scale_by_rss(initial_accumulator_value=0, eps)``: ``s += g^2``,
    ``u = g / sqrt(s + eps)`` where s > 0 and 0 elsewhere."""

    def __init__(self, params, lr=0.0, eps=1e-10, weight_decay=0.0):
        super().__init__(params, dict(lr=lr, eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = _decayed([p.grad for p in params], params, group["weight_decay"])
            sums = []
            for p in params:
                state = self.state[p]
                if "sum" not in state:
                    state["sum"] = torch.zeros_like(p)
                sums.append(state["sum"])
            torch._foreach_addcmul_(sums, grads, grads)
            for p, g, s in zip(params, grads, sums):
                u = torch.where(s > 0, g * torch.rsqrt(s + group["eps"]), torch.zeros_like(g))
                p.add_(u, alpha=-group["lr"])


def factored_dims(shape, min_dim_size_to_factor: int = 128):
    """optax ``_factored_dims``: (second largest, largest) axis, or None
    when the tensor is 1-D or its second largest dimension is below the
    threshold."""
    if len(shape) < 2:
        return None
    order = sorted(range(len(shape)), key=lambda i: shape[i])  # stable, as np.argsort
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return order[-2], order[-1]


class Adafactor(torch.optim.Optimizer):
    """optax ``scale_by_factored_rms(decay_rate, epsilon)`` then
    ``clip_by_block_rms(clip_threshold)``, then ``trace(beta1)`` when beta1
    is set; the JAX package's Adafactor (no relative step, lr from the
    scheduler). The second moments of a tensor whose two largest dims are
    at least 128 are factored: ``v_row`` is the mean over the largest dim,
    ``v_col`` over the second largest."""

    def __init__(self, params, lr=0.0, decay_rate=0.8, eps=1e-30, clip_threshold=1.0, beta1=None,
                 weight_decay=0.0):
        super().__init__(params, dict(lr=lr, decay_rate=decay_rate, eps=eps, clip_threshold=clip_threshold,
                                      beta1=beta1, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            grads = _decayed([p.grad for p in params], params, group["weight_decay"])
            for p, g in zip(params, grads):
                state = self.state[p]
                dims = factored_dims(p.shape)
                if not state:
                    state["step"] = torch.zeros((), dtype=torch.int32)
                    if dims is None:
                        state["v"] = torch.zeros_like(p)
                    else:
                        d1, d0 = dims
                        state["v_row"] = torch.zeros(p.shape[:d0] + p.shape[d0 + 1:], dtype=p.dtype, device=p.device)
                        state["v_col"] = torch.zeros(p.shape[:d1] + p.shape[d1 + 1:], dtype=p.dtype, device=p.device)
                    if group["beta1"]:
                        state["momentum_buffer"] = torch.zeros_like(p)
                t = state["step"].to(torch.float32) + 1.0
                decay = (1.0 - t ** (-group["decay_rate"])).to(p.device)
                grad_sqr = g * g + group["eps"]
                if dims is None:
                    state["v"].mul_(decay).add_((1.0 - decay) * grad_sqr)
                    u = g * state["v"] ** -0.5
                else:
                    d1, d0 = dims
                    v_row, v_col = state["v_row"], state["v_col"]
                    v_row.mul_(decay).add_((1.0 - decay) * grad_sqr.mean(dim=d0))
                    v_col.mul_(decay).add_((1.0 - decay) * grad_sqr.mean(dim=d1))
                    reduced_d1 = d1 - 1 if d1 > d0 else d1
                    row_factor = (v_row / v_row.mean(dim=reduced_d1, keepdim=True)) ** -0.5
                    u = g * row_factor.unsqueeze(d0) * (v_col ** -0.5).unsqueeze(d1)
                state["step"] += 1
                u = u / torch.clamp(torch.sqrt(torch.mean(u * u)) / group["clip_threshold"], min=1.0)
                if group["beta1"]:
                    u = state["momentum_buffer"].mul_(group["beta1"]).add_(u)
                p.add_(u, alpha=-group["lr"])


class Lamb(torch.optim.Optimizer):
    """optax ``chain(scale_by_adam(b1, b2, eps), add_decayed_weights(wd),
    scale_by_trust_ratio())``: the Adam update plus ``wd * p``, scaled per
    tensor by ||p|| / ||u|| (1 where either norm is 0)."""

    def __init__(self, params, lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            grads = [p.grad for p in params]
            for p in params:
                state = self.state[p]
                if not state:
                    state["step"] = torch.zeros((), dtype=torch.float32)
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                state["step"] += 1
            mu = [self.state[p]["exp_avg"] for p in params]
            nu = [self.state[p]["exp_avg_sq"] for p in params]
            torch._foreach_lerp_(mu, grads, 1.0 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
            for p, m, v in zip(params, mu, nu):
                count = self.state[p]["step"].to(p.device)
                u = (m / (1.0 - b1 ** count)) / (torch.sqrt(v / (1.0 - b2 ** count)) + group["eps"])
                if group["weight_decay"]:
                    u = u + group["weight_decay"] * p
                p_norm, u_norm = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
                ratio = torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(p_norm), p_norm / u_norm)
                p.add_(u * ratio, alpha=-group["lr"])


class Optimizer:
    """An optimiser of the JAX registry: its flags and its build."""

    @classmethod
    def add_args(cls, parser) -> None:
        pass

    @classmethod
    def build(cls, args, params) -> torch.optim.Optimizer:
        raise NotImplementedError


class AdamOptimizer(Optimizer):
    """``scale_by_adam`` (bias-corrected, ``eps_root = 0``) behind the coupled
    decay: ``torch.optim.Adam`` computes the same update."""

    @classmethod
    def add_args(cls, parser):
        parser.add_argument("--adam-betas", default="(0.9, 0.999)", metavar="B", help="betas for Adam optimizer")
        parser.add_argument("--use-old-adam", action="store_true", default=False,
                            help="parity no-op: the reference's opt-out of apex FusedAdam; one Adam here")
        parser.add_argument("--adam-eps", type=float, default=1e-8, metavar="D", help="epsilon for Adam optimizer")
        _add_weight_decay(parser)

    @classmethod
    def build(cls, args, params):
        b1, b2 = _parse_betas(getattr(args, "adam_betas", "(0.9, 0.999)"))
        return torch.optim.Adam(params, lr=0.0, betas=(b1, b2), eps=getattr(args, "adam_eps", 1e-8),
                                weight_decay=_wd(args))


class AdadeltaOptimizer(Optimizer):
    @classmethod
    def add_args(cls, parser):
        parser.add_argument("--adadelta-rho", type=float, default=0.9, metavar="RHO")
        parser.add_argument("--adadelta-eps", type=float, default=1e-6, metavar="EPS")
        _add_weight_decay(parser)
        parser.add_argument("--anneal-eps", action="store_true")

    @classmethod
    def build(cls, args, params):
        return torch.optim.Adadelta(params, lr=0.0, rho=getattr(args, "adadelta_rho", 0.9),
                                    eps=getattr(args, "adadelta_eps", 1e-6), weight_decay=_wd(args))


class AdagradOptimizer(Optimizer):
    @classmethod
    def add_args(cls, parser):
        _add_weight_decay(parser)

    @classmethod
    def build(cls, args, params):
        return Adagrad(params, eps=1e-10, weight_decay=_wd(args))


class AdamaxOptimizer(Optimizer):
    @classmethod
    def add_args(cls, parser):
        parser.add_argument("--adamax-betas", default="(0.9, 0.999)", metavar="B")
        parser.add_argument("--adamax-eps", type=float, default=1e-8, metavar="D")
        _add_weight_decay(parser)
        parser.add_argument("--no-bias-correction", default=False, action="store_true")

    @classmethod
    def build(cls, args, params):
        b1, b2 = _parse_betas(getattr(args, "adamax_betas", "(0.9, 0.999)"))
        return torch.optim.Adamax(params, lr=0.0, betas=(b1, b2), eps=getattr(args, "adamax_eps", 1e-8),
                                  weight_decay=_wd(args))


class AdafactorOptimizer(Optimizer):
    @classmethod
    def add_args(cls, parser):
        parser.add_argument("--adafactor-eps", default="(1e-30, 1e-3)", metavar="E")
        parser.add_argument("--clip-threshold", type=float, default=1.0, metavar="C")
        parser.add_argument("--decay-rate", type=float, default=-0.8, metavar="D")
        parser.add_argument("--beta1", type=float, default=None, metavar="B")
        _add_weight_decay(parser)
        parser.add_argument("--scale-parameter", action="store_true")
        parser.add_argument("--relative-step", action="store_true")
        parser.add_argument("--warmup-init", action="store_true")

    @classmethod
    def build(cls, args, params):
        eps = _parse_betas(getattr(args, "adafactor_eps", "(1e-30, 1e-3)"))
        return Adafactor(params, decay_rate=-getattr(args, "decay_rate", -0.8), eps=eps[0],
                         clip_threshold=getattr(args, "clip_threshold", 1.0), beta1=getattr(args, "beta1", None),
                         weight_decay=_wd(args))


class SGDOptimizer(Optimizer):
    """optax ``trace(momentum)`` (identity at momentum 0): torch's SGD
    without dampening computes the same buffer and update."""

    @classmethod
    def add_args(cls, parser):
        parser.add_argument("--momentum", default=0.0, type=float, metavar="M")
        _add_weight_decay(parser)

    @classmethod
    def build(cls, args, params):
        return torch.optim.SGD(params, lr=0.0, momentum=getattr(args, "momentum", 0.0), weight_decay=_wd(args))


class NAGOptimizer(Optimizer):
    """optax ``trace(momentum, nesterov=True)``: ``t = g + m t``, ``u = g + m t``;
    torch's SGD with ``nesterov=True`` and no dampening."""

    @classmethod
    def add_args(cls, parser):
        parser.add_argument("--momentum", default=0.99, type=float, metavar="M")
        _add_weight_decay(parser)

    @classmethod
    def build(cls, args, params):
        return torch.optim.SGD(params, lr=0.0, momentum=getattr(args, "momentum", 0.99), nesterov=True,
                               weight_decay=_wd(args))


class LambOptimizer(Optimizer):
    @classmethod
    def add_args(cls, parser):
        parser.add_argument("--lamb-betas", default="(0.9, 0.999)", metavar="B")
        parser.add_argument("--lamb-eps", type=float, default=1e-8, metavar="D")
        _add_weight_decay(parser)

    @classmethod
    def build(cls, args, params):
        b1, b2 = _parse_betas(getattr(args, "lamb_betas", "(0.9, 0.999)"))
        return Lamb(params, betas=(b1, b2), eps=getattr(args, "lamb_eps", 1e-8), weight_decay=_wd(args))


OPTIMIZERS = {
    "adam": AdamOptimizer,
    "adadelta": AdadeltaOptimizer,
    "adagrad": AdagradOptimizer,
    "adamax": AdamaxOptimizer,
    "adafactor": AdafactorOptimizer,
    "sgd": SGDOptimizer,
    "nag": NAGOptimizer,
    "lamb": LambOptimizer,
}


def build_optimizer(args, params) -> torch.optim.Optimizer:
    name = getattr(args, "optimizer", "adam")
    if name not in OPTIMIZERS:
        hint = f"BMUF and local SGD run with --use-bmuf over one of {sorted(OPTIMIZERS)}" if name in ("bmuf", "local_sgd") else \
            "not an optimiser of the JAX package"
        raise NotImplementedError(f"--optimizer {name}: {hint}")
    return OPTIMIZERS[name].build(args, params)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
