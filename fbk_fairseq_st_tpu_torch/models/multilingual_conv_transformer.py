"""multilingual_conv_transformer: one conv_transformer per language pair,
with encoders and decoders shared or not (COLING 2020, multilingual ST).

Counterpart of ``fbk_fairseq_st_tpu/models/multilingual_conv_transformer.py``
(reference examples/speech_recognition/models/
multilingual_conv_transformer.py:31-226): an ``nn.ModuleDict`` of
``ConvTransformerEncoder``s keyed ``"shared"`` under ``--share-encoders``,
else by source language, and one of decoders keyed ``"shared"`` under
``--share-decoders``, else by target language, each decoder over its
target language's dictionary. With ``--encoder-langtok`` a learned
``(n_langs, F)`` table ``lang_embeddings`` (normal, std ``F ** -0.5``)
holds one fbank-sized vector a language (the pair's source under ``src``,
its target under ``tgt``), merged into the encoder's input inside
``encode``, after the task's SpecAugment / TimeStretch: ``sum`` adds it to
every valid frame, ``concat`` prepends it as one frame to every row (the
padding rows of a fixed-shape batch included) and adds 1 to each length.
The decoder's language token replaces bos in the data
(``LangtokFilterBanksToTextDataset``) and in generation
(``generate(bos_token=)``).

``pair_view(pair)`` is what criterions and generators take: a
single-pair model over the shared modules (``forward``, ``encode``,
``init_cache``, ``decode_step``, ``reorder_cache``). ``forward`` runs the
pairs of a nested batch in ``lang_pairs`` order, so the BatchNorm running
stats of a shared encoder update pair after pair, as JAX threads its
state through them.

``--pretrained-encoder`` / ``--pretrained-decoder`` warm-start every
encoder / decoder from the ``encoder.*`` / ``decoder.*`` parameters of a
checkpoint the port's reader takes (its own files, JAX pickles, fork
``.pt`` files), as JAX's ``_load_pretrained`` (:267-334) merges its params
tree: a matrix whose leading dim grew by exactly ``len(langs)`` (the
dictionary with the language tokens appended) gets its old rows and keeps
its fresh init in the new ones; any other shape mismatch raises, and so
does a checkpoint key the module lacks unless ``--allow-partial-restore``.
The BatchNorm running stats stay fresh, as JAX merges the params alone.
JAX's merge drops a checkpoint's surplus list items (layers) silently;
the port's, by name, counts them as keys the module lacks.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ops.core import GeneratorLike, normal_
from . import conv_transformer
from .base import EncoderOut
from .conv_transformer import ConvTransformerEncoder, ConvTransformerEncoderConfig
from .transformer_decoder import TransformerDecoder, TransformerDecoderConfig


def lang_token(lang: str) -> str:
    return "__{}__".format(lang)


def lang_token_index(dictionary, lang: str) -> int:
    idx = dictionary.index(lang_token(lang))
    if idx == dictionary.unk():
        raise ValueError(f"cannot find language token for lang {lang}")
    return idx


class PairView:
    """One language pair's model over the multilingual model's modules:
    the pair's encoder (behind its language token) and decoder. Its train
    mode and parameters are the whole model's."""

    def __init__(self, parent: "MultilingualConvolutionalTransformerModel", pair: str):
        self.parent = parent
        self.pair = pair
        self.src_lang, self.tgt_lang = pair.split("-")
        self.encoder = parent.encoders[parent.encoder_key(pair)]
        self.decoder = parent.decoders[parent.decoder_key(pair)]
        self.max_source_positions = parent.max_source_positions
        self.max_target_positions = parent.max_target_positions

    @property
    def training(self) -> bool:
        return self.parent.training

    def train(self, mode: bool = True) -> "PairView":
        self.parent.train(mode)
        return self

    def eval(self) -> "PairView":
        return self.train(False)

    def parameters(self):
        return self.parent.parameters()

    def buffers(self):
        return self.parent.buffers()

    def __call__(self, batch: Dict[str, Any], generator: GeneratorLike = None):
        return self.forward(batch, generator)

    def encode(self, src_tokens, src_lengths, generator: GeneratorLike = None) -> EncoderOut:
        src_tokens, src_lengths = self.parent.apply_langtok(self.pair, src_tokens, src_lengths)
        return self.encoder(src_tokens, src_lengths, generator)

    def forward(self, batch: Dict[str, Any], generator: GeneratorLike = None):
        """As ``ConvolutionalTransformerModel.forward``: (logits, extra)
        with the EncoderOut in extra."""
        encoder_out = self.encode(batch["src_tokens"], batch["src_lengths"], generator)
        logits, extra = self.decoder(batch["prev_output_tokens"], encoder_out=encoder_out.encoder_out,
                                     encoder_padding_mask=encoder_out.encoder_padding_mask, generator=generator)
        extra["encoder_out"] = encoder_out
        return logits, extra

    def init_cache(self, batch: int, max_len: int, encoder_out: EncoderOut, dtype=torch.float32):
        return self.decoder.init_cache(batch, max_len, encoder_out.encoder_out, dtype)

    def decode_step(self, tokens, cache, step: int, encoder_out: EncoderOut):
        return self.decoder.step(tokens, cache, step, encoder_padding_mask=encoder_out.encoder_padding_mask)

    def reorder_cache(self, cache, order) -> None:
        self.decoder.reorder_cache(cache, order)


class MultilingualConvolutionalTransformerModel(nn.Module):
    def __init__(self, lang_pairs: List[str], langs: List[str], encoder_cfg: ConvTransformerEncoderConfig,
                 decoder_cfgs: Dict[str, TransformerDecoderConfig], share_encoders: bool, share_decoders: bool,
                 encoder_langtok: Optional[str], langtok_merge_strategy: str, audio_features: int,
                 pretrained_encoder: Optional[str] = None, pretrained_decoder: Optional[str] = None,
                 allow_partial_restore: bool = False):
        super().__init__()
        if encoder_langtok not in (None, "src", "tgt"):
            raise ValueError(f"--encoder-langtok {encoder_langtok!r}: src or tgt")
        if langtok_merge_strategy not in ("concat", "sum"):
            raise ValueError(f"--langtok-merge-strategy {langtok_merge_strategy!r}: concat or sum")
        self.lang_pairs = list(lang_pairs)
        self.langs = list(langs)
        self.share_encoders = share_encoders
        self.share_decoders = share_decoders
        self.encoder_langtok = encoder_langtok
        self.langtok_merge_strategy = langtok_merge_strategy
        self.audio_features = audio_features
        self.pretrained_encoder = pretrained_encoder
        self.pretrained_decoder = pretrained_decoder
        self.allow_partial_restore = allow_partial_restore
        self.encoder_cfg = encoder_cfg
        self.decoder_cfgs = decoder_cfgs
        self.encoders = nn.ModuleDict({key: ConvTransformerEncoder(encoder_cfg) for key in self._encoder_keys()})
        self.decoders = nn.ModuleDict({key: TransformerDecoder(decoder_cfgs[key]) for key in self._decoder_keys()})
        self.lang_embeddings = (nn.Parameter(torch.empty(len(self.langs), audio_features))
                                if encoder_langtok is not None else None)
        self.max_source_positions = encoder_cfg.max_positions
        self.max_target_positions = next(iter(decoder_cfgs.values())).max_positions

    def _encoder_keys(self) -> List[str]:
        return ["shared"] if self.share_encoders else sorted({p.split("-")[0] for p in self.lang_pairs})

    def _decoder_keys(self) -> List[str]:
        return ["shared"] if self.share_decoders else sorted({p.split("-")[1] for p in self.lang_pairs})

    def encoder_key(self, pair: str) -> str:
        return "shared" if self.share_encoders else pair.split("-")[0]

    def decoder_key(self, pair: str) -> str:
        return "shared" if self.share_decoders else pair.split("-")[1]

    def pair_view(self, pair: str) -> PairView:
        return PairView(self, pair)

    def init(self, generator: torch.Generator) -> "MultilingualConvolutionalTransformerModel":
        """Seeded initialisation (draws on ``generator``, a CPU generator),
        then the warm start when a pretrained checkpoint is named."""
        for key in sorted(self.encoders):
            self.encoders[key].init(generator)
        for key in sorted(self.decoders):
            self.decoders[key].init(generator)
        if self.lang_embeddings is not None:
            normal_(self.lang_embeddings, generator, self.audio_features ** -0.5)
        if self.pretrained_encoder or self.pretrained_decoder:
            self._load_pretrained()
        return self

    def apply_langtok(self, pair: str, src_tokens, src_lengths) -> Tuple[torch.Tensor, torch.Tensor]:
        """The pair's language vector merged into the fbank frames (JAX
        ``_apply_langtok`` :60-83)."""
        if self.encoder_langtok is None:
            return src_tokens, src_lengths
        src, tgt = pair.split("-")
        embed = self.lang_embeddings[self.langs.index(src if self.encoder_langtok == "src" else tgt)]
        embed = embed.to(src_tokens.dtype)
        if self.langtok_merge_strategy == "sum":
            t = src_tokens.shape[1]
            valid = torch.arange(t, device=src_tokens.device)[None, :] < src_lengths[:, None]
            return src_tokens + valid[..., None].to(src_tokens.dtype) * embed, src_lengths
        frame = embed.expand(src_tokens.shape[0], 1, embed.shape[-1])
        return torch.cat([frame, src_tokens], dim=1), src_lengths + 1

    def forward(self, batch: Dict[str, Dict[str, Any]], generator: GeneratorLike = None):
        """batch: {pair: a flat sub-batch}. Returns {pair: (logits, extra)}
        for the pairs present, run in ``lang_pairs`` order."""
        return {pair: self.pair_view(pair).forward(batch[pair], generator)
                for pair in self.lang_pairs if batch.get(pair)}

    # -- the warm start -----------------------------------------------------

    def _load_pretrained(self) -> None:
        from ..train.checkpoint import load_checkpoint_to_cpu

        loaded: Dict[str, Dict[str, torch.Tensor]] = {}
        for side, path, modules in (("encoder", self.pretrained_encoder, self.encoders),
                                    ("decoder", self.pretrained_decoder, self.decoders)):
            if not path:
                continue
            if path not in loaded:
                loaded[path] = load_checkpoint_to_cpu(path)["model"]
            prefix = side + "."
            source = {k[len(prefix):]: v for k, v in loaded[path].items() if k.startswith(prefix)}
            if not source:
                raise ValueError(f"{path}: the checkpoint has no {side} parameters")
            for key, module in modules.items():
                self._merge(module, source, f"{side}s.{key}")

    def _merge(self, module: nn.Module, source: Dict[str, torch.Tensor], where: str) -> None:
        params = dict(module.named_parameters())
        known = set(params) | {name for name, _ in module.named_buffers()}
        unexpected = sorted(set(source) - known)
        if unexpected and not self.allow_partial_restore:
            raise ValueError(f"Cannot load from checkpoint, unexpected keys at {where}: {unexpected}")
        with torch.no_grad():
            for name, param in params.items():
                if name not in source:
                    continue
                value = source[name].to(param.dtype)
                if value.shape == param.shape:
                    param.copy_(value)
                elif (value.dim() == param.dim() and value.shape[1:] == param.shape[1:]
                      and param.shape[0] == value.shape[0] + len(self.langs)):
                    # the dictionary grew by the language tokens: old rows copied
                    param[: value.shape[0]].copy_(value)
                else:
                    raise ValueError(f"Shape mismatch at {where}.{name}: checkpoint {tuple(value.shape)} "
                                     f"vs model {tuple(param.shape)}")


# ---------------------------------------------------------------------------
# Arch presets and construction
# ---------------------------------------------------------------------------

# arch -> (encoder dim, FFN dim, heads), JAX :352-381
ARCHITECTURES = {
    "multilingual_conv_transformer": (256, 768, 4),
    "multilingual_conv_transformer_big": (512, 1024, 8),
    "multilingual_conv_transformer_big2": (512, 2048, 8),
}
# the model's own options beside the conv_transformer's (JAX add_args);
# --share-decoder-embeddings is parsed and never read, as in JAX
_MODEL_OPTIONS = dict(share_encoders=False, share_decoders=False, share_decoder_embeddings=False,
                      pretrained_encoder=None, pretrained_decoder=None)


def defaults(arch: str) -> Dict[str, Any]:
    """The options of ``arch`` with their values when none is given."""
    return dict(conv_transformer._base_defaults(*ARCHITECTURES[arch]), **_MODEL_OPTIONS)


def _pairs(lang_pairs) -> List[str]:
    return list(lang_pairs) if isinstance(lang_pairs, (list, tuple)) else lang_pairs.split(",")


def configs(arch: str, dicts, lang_pairs, share_decoders: bool = False, **overrides
            ) -> Tuple[ConvTransformerEncoderConfig, Dict[str, TransformerDecoderConfig]]:
    """The encoder config and one decoder config a decoder key (JAX
    ``build_model`` :199-245): each from the conv_transformer options over
    its target language's dictionary, the first pair's under
    ``share_decoders``; the encoder's from the last pair built."""
    pairs = _pairs(lang_pairs)
    unknown = set(overrides) - set(defaults(arch))
    if unknown:
        raise TypeError(f"unknown multilingual_conv_transformer options: {sorted(unknown)}")
    conv_overrides = {k: v for k, v in overrides.items() if k not in _MODEL_OPTIONS}
    targets = [pairs[0].split("-")[1]] if share_decoders else [p.split("-")[1] for p in pairs]
    encoder_cfg, decoder_cfgs = None, {}
    for tgt in targets:
        encoder_cfg, dec_cfg = conv_transformer.configs_from(
            conv_transformer._base_defaults(*ARCHITECTURES[arch]), dicts[tgt], None, **conv_overrides)
        decoder_cfgs.setdefault("shared" if share_decoders else tgt, dec_cfg)
    return encoder_cfg, decoder_cfgs


def build_model(arch: str, dicts, src_dict=None, device: DeviceLike = None, seed: int = 0, train: bool = False,
                lang_pairs=None, encoder_langtok: Optional[str] = None, langtok_merge_strategy: str = "concat",
                allow_partial_restore: bool = False, **overrides) -> MultilingualConvolutionalTransformerModel:
    """Build ``arch`` over ``dicts`` ({language: Dictionary}, the task's)
    for ``lang_pairs`` (a list or "src-tgt,..."), with weights drawn from
    ``seed`` (then the warm start, if named) on ``device`` (the CUDA card
    when None; raises without one), in eval mode unless ``train``.
    ``src_dict`` is unused: the source side is audio."""
    device = resolve_device(device)
    if lang_pairs is None:
        raise ValueError("multilingual_conv_transformer needs --lang-pairs")
    pairs = _pairs(lang_pairs)
    options = dict(_MODEL_OPTIONS, **{k: v for k, v in overrides.items() if k in _MODEL_OPTIONS})
    encoder_cfg, decoder_cfgs = configs(arch, dicts, pairs, **overrides)
    model = MultilingualConvolutionalTransformerModel(
        lang_pairs=pairs, langs=sorted({x for p in pairs for x in p.split("-")}), encoder_cfg=encoder_cfg,
        decoder_cfgs=decoder_cfgs, share_encoders=options["share_encoders"],
        share_decoders=options["share_decoders"], encoder_langtok=encoder_langtok,
        langtok_merge_strategy=langtok_merge_strategy, audio_features=encoder_cfg.frontend.audio_features,
        pretrained_encoder=options["pretrained_encoder"], pretrained_decoder=options["pretrained_decoder"],
        allow_partial_restore=allow_partial_restore)
    model.init(torch.Generator().manual_seed(seed))
    return model.to(device).train(train)
