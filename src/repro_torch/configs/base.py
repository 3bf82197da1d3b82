"""Model / shape configuration schema for every assigned architecture.

The PyTorch port's copy of ``repro.configs.base``: the fields the
architectures set and the derived shapes the serving path reads, with
``dtype`` a torch dtype, and the training options of the dense trainer
(``remat``, ``loss_chunk``).  MoE dispatch runs on one device, so the
reference's ``moe_tp`` and ``moe_impl``, which pick a mesh mode, come with
the distributed slice, as do the sharding options."""
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

    # attention
    rope_theta: float = 1e4
    window: int | None = None    # sliding-window attention

    # SSM (mamba2 / jamba)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256

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
