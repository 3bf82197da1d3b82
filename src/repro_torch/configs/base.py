"""Model / shape configuration schema for every assigned architecture.

The PyTorch port's copy of ``repro.configs.base``: the fields the
architectures set and the derived shapes the serving path reads, with
``dtype`` a torch dtype, and the training options of the dense trainer
(``remat``, ``loss_chunk``), the MoE sublayer's mesh mode (``moe_tp``,
``moe_impl``: ``layers.moe_mode``), and the parameter count."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


# sublayer kinds; a layer is a tuple of sublayers, a period a tuple of layers
ATTN, MAMBA, XATTN = "attn", "mamba", "xattn"
MLP, MOE = "mlp", "moe"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0              # 0 -> d_model // n_heads

    # repeating period: tuple of layers, each a tuple of sublayer kinds,
    # e.g. jamba: (("mamba","moe"), ("mamba","mlp"), ..., ("attn","moe"), ...).
    # empty -> every layer is ("attn", "mlp"/"moe").
    period: tuple = ()

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    moe_tp: bool = False         # experts < |model| axis: shard d_ff instead
    moe_impl: str = "psum"       # "psum" (tokens replicated over model) |
    #                              "a2a" (GLSU-style token all-to-all EP)

    # attention
    rope_theta: float = 1e4
    window: int | None = None    # sliding-window attention

    # SSM (mamba2 / jamba)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv: int = 4

    # enc-dec
    n_enc_layers: int = 0
    # vlm / audio frontend stub
    n_ctx_tokens: int = 0        # image patches / audio frames per sample
    d_ctx: int = 0               # frontend embedding dim (projected to d_model)

    # numerics / training
    dtype: Any = torch.bfloat16
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    remat: bool = True           # recompute each layer period in the backward
    loss_chunk: int = 0          # chunked cross-entropy (0 = single shot)

    # ---------------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding/head tables padded to a 256 multiple so the vocab dim
        shards over any mesh axis (mamba2's 50280, seamless' 256206...).
        Logits for padded ids are masked to -inf in the loss/decode paths."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def layer_period(self) -> tuple:
        if self.period:
            return self.period
        return ((ATTN, MOE if self.n_experts else MLP),)

    @property
    def n_periods(self) -> int:
        p = len(self.layer_period)
        assert self.n_layers % p == 0, (self.name, self.n_layers, p)
        return self.n_layers // p

    @property
    def d_inner_ssm(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner_ssm // self.ssm_head_dim

    def _sublayer_params(self, kind: str) -> int:
        d, hd = self.d_model, self.head_dim
        if kind in (ATTN, XATTN):
            return (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                    + self.n_heads * hd * d + d)
        if kind == MAMBA:
            di = self.d_inner_ssm
            H, N = self.n_ssm_heads, self.ssm_state
            return (d * (2 * di + 2 * N + H) + self.ssm_conv * (di + 2 * N)
                    + 3 * H + di + di * d + d)
        if kind == MLP:
            return 3 * d * self.d_ff + d
        if kind == MOE:
            ffe = self.d_ff_expert or self.d_ff
            return d * self.n_experts + self.n_experts * 3 * d * ffe + d
        raise ValueError(kind)

    def n_params(self) -> int:
        """Total parameter count (embedding included), the reference's
        formula: the vocabulary unpadded, conv_b not counted."""
        d = self.d_model
        n = self.vocab_size * d                       # embed
        if not self.tie_embeddings:
            n += d * self.vocab_size                  # head
        for layer in self.layer_period:
            for kind in layer:
                n += self.n_periods * self._sublayer_params(kind)
        n += d                                        # final norm
        if self.family == "encdec":
            n += self.n_enc_layers * (self._sublayer_params(ATTN)
                                      + self._sublayer_params(MLP)) + d
        if self.d_ctx:
            n += self.d_ctx * d                       # frontend projection
        return n

    def n_active_params(self) -> int:
        """Active (per-token) parameters: MoE counts top-k experts only."""
        if not self.n_experts:
            return self.n_params()
        ffe = self.d_ff_expert or self.d_ff
        n_moe = sum(1 for layer in self.layer_period
                    for k in layer if k == MOE) * self.n_periods
        inactive = n_moe * (self.n_experts - self.experts_per_token) \
            * 3 * self.d_model * ffe
        return self.n_params() - inactive
