"""What sets the model families apart outside their own modules, decided
in one place: the extra input a config's family takes beside its tokens,
the module that builds its params, and its teacher-forced text logits.

An enc-dec model (``n_encoder_layers``) takes ``frames`` (B,
encoder_seq, d) and is :mod:`repro_torch.models.encdec`; a VLM
(``prefix_tokens``) takes ``prefix_embeds`` (B, prefix_tokens, d); every
other family is :mod:`repro_torch.models.transformer` with tokens alone.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs import ModelConfig
from . import encdec
from . import transformer as tf
from .layers import FaultConfig


def extra_name(cfg: ModelConfig) -> Optional[str]:
    """``"frames"``, ``"prefix_embeds"`` or ``None``."""
    if cfg.n_encoder_layers:
        return "frames"
    if cfg.prefix_tokens:
        return "prefix_embeds"
    return None


def extra_shape(cfg: ModelConfig) -> Tuple[int, int]:
    """One row's extra input: ``(encoder_seq, d)`` frames or
    ``(prefix_tokens, d)`` prefix embeddings."""
    n = cfg.encoder_seq if cfg.n_encoder_layers else cfg.prefix_tokens
    return (n, cfg.d_model)


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16,
                device="cuda", place=None) -> Dict:
    """Random params of the config's family from ``seed`` (``place``: see
    :func:`repro_torch.models.transformer.init_params`)."""
    init = encdec.init_params if cfg.n_encoder_layers else tf.init_params
    return init(cfg, seed, dtype, device=device, place=place)


def text_logits(params, cfg: ModelConfig, tokens, *,
                fi: Optional[FaultConfig] = None, remat: bool = False,
                **extra):
    """Teacher-forced logits of ``tokens`` (B, S) alone, and the MoE
    load-balance loss (0 for other models): an enc-dec model's decoder
    over its encoded ``frames``, a VLM's forward with the prefix
    positions' logits dropped (the reference's ``score``, sweep and loss
    forward).  ``extra`` is the family's input named by
    :func:`extra_name`."""
    if cfg.n_encoder_layers:
        enc = encdec.encode(params, cfg, extra["frames"], fi=fi, remat=remat)
        logits = encdec.decode(params, cfg, tokens, enc_out=enc, fi=fi,
                               remat=remat)[0]
        return logits, torch.zeros((), dtype=torch.float32,
                                   device=logits.device)
    logits, _, aux = tf.forward_logits(params, cfg, tokens, fi=fi,
                                       remat=remat, **extra)
    return logits[:, cfg.prefix_tokens:], aux
