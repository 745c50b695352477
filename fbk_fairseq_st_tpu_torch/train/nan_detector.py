"""NaN/Inf localisation for a failing update.

Counterpart of ``fbk_fairseq_st_tpu/train/nan_detector.py`` (reference
fairseq/nan_detector.py and the trainer's re-run, trainer.py:444-451): when
an update's gradient norm is not finite, ``Trainer.flush_logs`` re-runs the
forward of the update's last batch and reports which parameters, and then
which forward outputs, first hold a NaN or an Inf.
"""

from __future__ import annotations

import logging
from typing import Dict, Iterable, List, Tuple

import torch

logger = logging.getLogger(__name__)


def check_named(tensors: Iterable[Tuple[str, torch.Tensor]], name: str = "tree") -> List[str]:
    """The names of the non-finite float tensors, with their NaN and Inf counts."""
    bad = []
    for path, t in tensors:
        if not isinstance(t, torch.Tensor) or not t.is_floating_point():
            continue
        finite = torch.isfinite(t)
        if not bool(finite.all()):
            n_nan, n_inf = int(torch.isnan(t).sum()), int(torch.isinf(t).sum())
            bad.append(f"{name}/{path}: {n_nan} NaNs, {n_inf} Infs (shape {tuple(t.shape)})")
    return bad


class NanDetector:
    """Context manager: on exit, logs what ``check`` found (and raises
    ``FloatingPointError`` with the first finding when asked to)."""

    def __init__(self, raise_on_nan: bool = False):
        self.raise_on_nan = raise_on_nan
        self.findings: List[str] = []

    def __enter__(self):
        return self

    def check(self, tensors: Dict[str, torch.Tensor], name: str) -> None:
        self.findings.extend(check_named(tensors.items(), name))

    def __exit__(self, exc_type, exc, tb):
        for f in self.findings:
            logger.warning(f"NanDetector: {f}")
        if self.findings and self.raise_on_nan:
            raise FloatingPointError(self.findings[0])
        return False


def analyze_failing_step(trainer, batch) -> List[str]:
    """Re-run the forward of a failing batch in eval mode and list the
    first non-finite tensors: the parameters, then the logits."""
    model = trainer.model
    findings = check_named(model.named_parameters(), "params")
    was_training = model.training
    try:
        model.eval()
        with torch.no_grad():
            net_output = model(batch)
        # a multilingual model gives {pair: (logits, extra)}
        outputs = net_output.items() if isinstance(net_output, dict) else [("logits", net_output)]
        for name, out in outputs:
            logits = out[0] if isinstance(out, tuple) else out
            findings.extend(check_named([(name, logits)], "forward"))
    except Exception as e:  # a diagnostic path: report, never mask the first error
        findings.append(f"forward itself failed: {e}")
    finally:
        model.train(was_training)
    for f in findings:
        logger.warning(f"NanDetector: {f}")
    return findings
