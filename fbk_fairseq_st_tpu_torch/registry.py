"""Name -> component registries over what the port has, and the arch
presets' defaults on a parsed args namespace.

Counterpart of ``fbk_fairseq_st_tpu/registry.py`` (reference
fairseq/registry.py and fairseq/models/__init__.py:124-159): ``TASKS``,
``CRITERIONS``, the model ``ARCHITECTURES`` the port runs and the text
codecs ``TOKENIZERS`` / ``BPES``, each a ``Registry`` over its package's
table whose entries may add their CLI flags (``add_args``); a
``--user-dir`` module adds entries through ``register`` (and an arch alias
through ``register_architecture``);
``apply_architecture`` fills every option of ``args.arch`` that the
namespace lacks with the preset's value (the JAX presets'
``args.x = getattr(args, "x", default)``; a lightconv preset runs on the
namespace itself, so the options it derives follow the given ones), so a
parsed or checkpointed namespace carries the whole configuration.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict

from . import criterions, models, tasks
from .data import encoders


class Registry:
    """A named set of components over ``entries`` (the package's own table,
    shared, so what ``register`` adds every user of that table sees); a
    class may define ``add_args(parser)``."""

    def __init__(self, kind: str, entries: Dict[str, Any]):
        self.kind = kind
        self._entries = entries

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __getitem__(self, name: str) -> Any:
        if name not in self._entries:
            raise KeyError(f"Unknown {self.kind}: {name!r}. Available: {sorted(self._entries)}")
        return self._entries[name]

    def add_args(self, name: str, parser) -> None:
        cls = self[name]
        if hasattr(cls, "add_args"):
            cls.add_args(parser)

    def register(self, name: str):
        """Decorator: ``name`` -> the class (a duplicate name raises)."""
        def wrap(cls):
            if name in self._entries:
                raise ValueError(f"Cannot register duplicate {self.kind} ({name})")
            self._entries[name] = cls
            return cls

        return wrap


TASKS = Registry("task", tasks.TASKS)
CRITERIONS = Registry("criterion", criterions.CRITERIONS)
ARCHITECTURES = Registry("architecture", models.ARCHITECTURES)
TOKENIZERS = Registry("tokenizer", encoders.TOKENIZERS)
BPES = Registry("bpe", encoders.BPES)


def register_architecture(name: str, like: str) -> None:
    """A new arch ``name`` with the preset of the ported arch ``like``, in
    its family (the JAX ``register_model_architecture`` of a preset that
    calls another's); a taken name raises."""
    if name in ARCHITECTURES:
        raise ValueError(f"Cannot register duplicate architecture ({name})")
    family = models._family(like)
    family.ARCHITECTURES[name] = family.ARCHITECTURES[like]
    ARCHITECTURES._entries[name] = family


def apply_architecture(args: argparse.Namespace) -> None:
    """Back-fill the preset's options of ``args.arch`` onto ``args``; an
    arch the port lacks raises ``NotImplementedError``."""
    arch = getattr(args, "arch", None)
    if arch is None:
        return
    defaults = models.arch_defaults(arch)
    family = models.ARCHITECTURES[arch]
    if hasattr(family, "apply_preset"):  # a preset whose defaults derive from given options
        family.apply_preset(arch, args)
    for name, value in defaults.items():
        if not hasattr(args, name):
            setattr(args, name, value)
    # JAX's lightconv base_architecture (models/lightconv.py:527-530): a GLU
    # left at its parser default (None) is on
    for name in ("encoder_glu", "decoder_glu"):
        if name in defaults and getattr(args, name) is None:
            setattr(args, name, True)

