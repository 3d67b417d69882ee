"""config → Model bundle: init / abstract / loss / prefill / decode.

Port of ``repro.models.build``. The serving layer only ever talks to a
``Model``. ``build`` serves the dense, moe and vlm families
(``lm_forward``; the moe family's loss adds the router's aux loss and,
for deepseek, the multi-token prediction loss), the hybrid family
(``hybrid_forward``, zamba2), the ssm family (``xlstm_forward``) and the
audio family (``encdec_forward``, whisper: a prefill runs the encoder on
``batch["frames"]``), and builds the spectral family
(``spectral_forward``, fourier_lm: a masked LM with a loss and a prefill,
no decode step). Every family is ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import softmax_xent
from repro_torch.models.param import abstract_params, init_params, param_count, partition_specs

__all__ = ["Model", "build"]

#: ROADMAP queue 1, item 12's sub-item that ports each family still
#: missing: none is (the moe family came last, with item 12 (c)).
PENDING: dict[str, str] = {}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    skeleton: Any
    loss_fn: Callable          # (params, batch) -> (loss, metrics)
    prefill_fn: Callable       # (params, batch, caches) -> (logits, caches)
    decode_fn: Callable | None # (params, token, pos, caches, extras) -> (logits, caches)
    init_cache_fn: Callable | None  # (batch, max_len, dtype, device) -> caches

    def init(self, generator: torch.Generator, dtype=None, device=None):
        return init_params(self.skeleton, generator, dtype, device)

    def abstract(self, dtype=None):
        return abstract_params(self.skeleton, dtype)

    def specs(self, rules: dict):
        return partition_specs(self.skeleton, rules)

    @property
    def n_params(self) -> int:
        return param_count(self.skeleton)


def _lm_like(cfg: ModelConfig, forward, skel, init_cache):
    """Bundle for decoder-style LMs (dense/moe/vlm/hybrid/ssm)."""

    def loss_fn(params, batch):
        extras = {}
        if "patches" in batch:
            extras["prefix_embeds"] = batch["patches"]
        if cfg.mtp:
            logits, _, aux, hidden = forward(params, batch["tokens"], cfg, return_hidden=True,
                                             **extras)
        else:
            logits, _, aux = forward(params, batch["tokens"], cfg, **extras)
        n_prefix = logits.shape[1] - batch["tokens"].shape[1]
        logits_tok = logits[:, n_prefix:]
        loss = softmax_xent(logits_tok[:, :-1], batch["tokens"][:, 1:])
        metrics = {"xent": loss}
        if cfg.moe is not None:
            loss = loss + cfg.moe.aux_loss_weight * aux
            metrics["aux"] = aux
        if cfg.mtp:
            ml = T.mtp_logits(params, hidden, batch["tokens"], cfg)
            mtp_loss = softmax_xent(ml[:, :-1], batch["tokens"][:, 2:])
            loss = loss + cfg.mtp_weight * mtp_loss
            metrics["mtp"] = mtp_loss
        metrics["loss"] = loss
        return loss, metrics

    def prefill_fn(params, batch, caches):
        extras = {}
        if "patches" in batch:
            extras["prefix_embeds"] = batch["patches"]
        logits, caches, _ = forward(
            params, batch["tokens"], cfg, caches=caches, **extras
        )
        return logits[:, -1], caches

    def decode_fn(params, token, pos, caches, extras=None):
        logits, caches, _ = forward(
            params, token, cfg, pos0=pos, caches=caches, decode=True
        )
        return logits[:, -1], caches

    return Model(cfg, skel, loss_fn, prefill_fn, decode_fn, init_cache)


def _encdec(cfg: ModelConfig) -> Model:
    """Bundle for the encoder-decoder (audio): prefill runs the encoder on
    ``batch["frames"]`` and fills the cross K/V caches; decode reads them."""

    def loss_fn(params, batch):
        logits, _, _ = T.encdec_forward(params, batch["tokens"], cfg, frames=batch["frames"])
        loss = softmax_xent(logits[:, :-1], batch["tokens"][:, 1:])
        return loss, {"xent": loss, "loss": loss}

    def prefill_fn(params, batch, caches):
        enc_out = T.encoder_forward(params, batch["frames"], cfg)
        logits, caches, _ = T.encdec_forward(params, batch["tokens"], cfg, enc_out=enc_out,
                                             caches=caches)
        return logits[:, -1], caches

    def decode_fn(params, token, pos, caches, extras=None):
        logits, caches, _ = T.encdec_forward(params, token, cfg, pos0=pos, caches=caches,
                                             decode=True)
        return logits[:, -1], caches

    def init_cache(batch, max_len, dtype=torch.bfloat16, device=None):
        return T.encdec_init_cache(cfg, batch, max_len, dtype, device)

    return Model(cfg, T.encdec_skel(cfg), loss_fn, prefill_fn, decode_fn, init_cache)


def _spectral(cfg: ModelConfig) -> Model:
    """FNet-style masked LM (bidirectional mixing, so no causal decode)."""

    def loss_fn(params, batch):
        logits, _, _ = T.spectral_forward(params, batch["tokens"], cfg)
        loss = softmax_xent(logits, batch.get("targets", batch["tokens"]), batch.get("mlm_mask"))
        return loss, {"xent": loss, "loss": loss}

    def prefill_fn(params, batch, caches):
        logits, _, _ = T.spectral_forward(params, batch["tokens"], cfg)
        return logits[:, -1], caches

    return Model(cfg, T.spectral_skel(cfg), loss_fn, prefill_fn, None, None)


def build(cfg: ModelConfig) -> Model:
    if cfg.family in ("dense", "moe", "vlm"):
        return _lm_like(
            cfg, T.lm_forward, T.lm_skel(cfg),
            lambda b, s, dtype=torch.bfloat16, device=None: T.lm_init_cache(
                cfg, b, s, dtype, device),
        )
    if cfg.family == "hybrid":
        return _lm_like(
            cfg, T.hybrid_forward, T.hybrid_skel(cfg),
            lambda b, s, dtype=torch.bfloat16, device=None: T.hybrid_init_cache(
                cfg, b, s, dtype, device),
        )
    if cfg.family == "ssm":
        # float32 states whatever dtype is asked for, as the reference's
        return _lm_like(
            cfg, T.xlstm_forward, T.xlstm_skel(cfg),
            lambda b, s, dtype=torch.float32, device=None: T.xlstm_init_cache(
                cfg, b, s, dtype, device),
        )
    if cfg.family == "audio":
        return _encdec(cfg)
    if cfg.family == "spectral":
        return _spectral(cfg)
    if cfg.family in PENDING:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            f"(ROADMAP, queue 1, item {PENDING[cfg.family]})"
        )
    raise ValueError(f"unknown family {cfg.family}")
