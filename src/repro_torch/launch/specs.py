"""``input_specs``: meta-tensor stand-ins for every model input, per
(architecture x input shape), ported from ``repro.launch.specs``. A meta
tensor has the shape and dtype of the real input and no storage: the
dry-run (`repro_torch.launch.dryrun`) traces against these.

Shapes:
  train_4k     -> train step   (tokens + labels, full sequence)
  prefill_32k  -> prefill      (tokens + fresh cache)
  decode_32k   -> serve step   (ONE new token against a seq_len cache)
  long_500k    -> serve step   (window/SSM cache; batch 1)

long_500k policy: architectures with attention run the sliding-window
variant (window 4096) at this shape (``adapt_config`` applies the
override), so the cache is O(window), not O(524288). SSM archs are
natively O(1)-state.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models.cache import make_cache
from repro_torch.models.config import ArchConfig, InputShape, INPUT_SHAPES
from repro_torch.models.model import Model
from repro_torch.models.ssm import F32_KEYS
from repro_torch.training.tree import flatten, unflatten

LONG_CONTEXT_WINDOW = 4096
META = torch.device("meta")


def has_attention(cfg: ArchConfig) -> bool:
    return "a" in cfg.pattern


def adapt_config(cfg: ArchConfig, shape: InputShape) -> ArchConfig:
    """Per-shape architecture adaptation (the long_500k window override)."""
    if shape.name == "long_500k" and has_attention(cfg) and not cfg.attn_window:
        return cfg.with_overrides(attn_window=LONG_CONTEXT_WINDOW)
    return cfg


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _token_spec(cfg: ArchConfig, batch: int, seq: int) -> torch.Tensor:
    if cfg.n_codebooks > 1:
        return _spec((batch, seq, cfg.n_codebooks), torch.int32)
    return _spec((batch, seq), torch.int32)


def _extras(cfg: ArchConfig, batch: int, seq: int, dtype) -> Dict:
    out = {}
    if cfg.frontend == "vision":
        nv = min(cfg.n_vision_tokens, seq)
        out["vision_embeds"] = _spec((batch, nv, cfg.d_model), dtype)
    if cfg.cross_attention:
        out["cond_memory"] = _spec((batch, cfg.n_cond_tokens, cfg.d_model),
                                   dtype)
    return out


def _positions_spec(cfg: ArchConfig, batch: int, seq: int) -> torch.Tensor:
    if cfg.mrope_sections:
        return _spec((batch, seq, 3), torch.int32)
    return _spec((batch, seq), torch.int32)


def input_specs(cfg: ArchConfig, shape: InputShape,
                dtype=torch.bfloat16, cache_dtype=None) -> Tuple[Dict, Dict]:
    """Returns (batch_specs, cache_specs). cache_specs is {} for train.
    cache_dtype overrides the KV-cache element type (fp8 cache variant:
    ``torch.float8_e4m3fn``)."""
    cache_dtype = cache_dtype or dtype
    cfg = adapt_config(cfg, shape)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        batch = {
            "tokens": _token_spec(cfg, B, S),
            "labels": _token_spec(cfg, B, S),
            **_extras(cfg, B, S, dtype),
        }
        if cfg.mrope_sections:
            batch["positions"] = _positions_spec(cfg, B, S)
        return batch, {}

    if shape.kind == "prefill":
        batch = {
            "tokens": _token_spec(cfg, B, S),
            **_extras(cfg, B, S, dtype),
        }
        if cfg.mrope_sections:
            batch["positions"] = _positions_spec(cfg, B, S)
        return batch, make_cache(cfg, B, S, cache_dtype, device=META)

    # decode: ONE new token against a cache of seq_len (ring-capped by window)
    extras = _extras(cfg, B, 1, dtype)
    if cfg.cross_kv_cache:
        extras.pop("cond_memory", None)  # served from the cached projections
    batch = {
        "tokens": _token_spec(cfg, B, 1),
        "positions": _positions_spec(cfg, B, 1),
        **extras,
    }
    return batch, make_cache(cfg, B, S, cache_dtype, device=META)


def param_specs(model: Model) -> Dict:
    """Meta tensors of every parameter in the params tree's nesting, in the
    dtypes `Model.init` gives (the SSM's ``A_log``, ``dt_bias`` and ``D``
    in f32, the rest in the model dtype)."""
    shapes = model.param_shapes()
    return unflatten(shapes, [
        _spec(s, torch.float32 if path.rsplit("/", 1)[-1] in F32_KEYS
              else model.dtype)
        for path, s in flatten(shapes)])


def get_shape(name: str) -> InputShape:
    return INPUT_SHAPES[name]
