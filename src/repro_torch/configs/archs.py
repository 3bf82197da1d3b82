"""The assigned architectures (exact published configurations).

Sources are cited per entry.
"""
from __future__ import annotations

import dataclasses

import torch

from .base import ATTN, MAMBA, MLP, MOE, XATTN, ModelConfig

CONFIGS: dict[str, ModelConfig] = {}


def _reg(cfg: ModelConfig) -> ModelConfig:
    CONFIGS[cfg.name] = cfg
    return cfg


# --- MoE -------------------------------------------------------------------

# [hf:Qwen/Qwen3-235B-A22B; hf] 94L d4096 64H GQA kv=4, expert ff 1536,
# 128 experts top-8, head_dim 128
_reg(ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_head=128,
    d_ff=1536, d_ff_expert=1536, vocab_size=151936,
    n_experts=128, experts_per_token=8,
    rope_theta=1e6, norm_eps=1e-6))

# [arXiv:2401.04088; hf] Mixtral 8x7B: 32L d4096 32H kv=8 ff14336,
# 8 experts top-2, sliding window 4096
_reg(ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    d_ff_expert=14336, vocab_size=32000,
    n_experts=8, experts_per_token=2, moe_tp=True,
    window=4096, rope_theta=1e6, norm_eps=1e-5))

# --- enc-dec audio ----------------------------------------------------------

# [arXiv:2308.11596; hf] SeamlessM4T-large-v2 text dec: 24L d1024 16H ff8192;
# speech encoder stubbed as precomputed frames (d_ctx=1024)
_reg(ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab_size=256206,
    period=((ATTN, XATTN, MLP),),
    d_ctx=1024, rope_theta=1e4, norm_eps=1e-5))

# --- hybrid -----------------------------------------------------------------

# [arXiv:2403.19887; hf] Jamba-1.5-large: 72L d8192 64H kv=8 ff24576,
# attn:mamba 1:7, MoE (16e top-2) every other layer
_reg(ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=24576,
    d_ff_expert=24576, vocab_size=65536,
    n_experts=16, experts_per_token=2,
    period=((MAMBA, MOE), (MAMBA, MLP), (MAMBA, MOE), (MAMBA, MLP),
            (ATTN, MOE), (MAMBA, MLP), (MAMBA, MOE), (MAMBA, MLP)),
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    rope_theta=1e4, norm_eps=1e-6))

# --- dense ------------------------------------------------------------------

# [arXiv:2404.14219; unverified] phi3-mini 3.8B
_reg(ModelConfig(
    name="phi3-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab_size=32064, rope_theta=1e4, norm_eps=1e-5))

# [arXiv:2401.02954; hf] deepseek-llm-7b
_reg(ModelConfig(
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32, d_ff=11008,
    vocab_size=102400, rope_theta=1e4, norm_eps=1e-6))

# [hf:THUDM/glm-4-9b; hf] glm4-9b — extreme GQA (kv=2)
_reg(ModelConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2, d_ff=13696,
    vocab_size=151552, rope_theta=1e4, norm_eps=1.5625e-7))

# [arXiv:2407.21783; unverified] llama3-8b
_reg(ModelConfig(
    name="llama3-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=128256, rope_theta=5e5, norm_eps=1e-5))

# --- VLM --------------------------------------------------------------------

# [hf:meta-llama/Llama-3.2-11B-Vision; unverified] 40L llama trunk,
# cross-attn image layers every 5th layer; vision frontend stubbed
# (1601 patch embeddings x 4 tiles, projected from d_ctx=7680)
_reg(ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=128256,
    period=((ATTN, MLP), (ATTN, MLP), (XATTN, MLP), (ATTN, MLP),
            (ATTN, MLP)),
    n_ctx_tokens=1601 * 4, d_ctx=7680,
    rope_theta=5e5, norm_eps=1e-5))

# --- SSM --------------------------------------------------------------------

# [arXiv:2405.21060; unverified] mamba2-370m: 48L d1024, attention-free,
# SSD state 128
_reg(ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=0,
    vocab_size=50280,
    period=((MAMBA,),),
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    norm_eps=1e-5, tie_embeddings=True))


# --- reduced smoke variants --------------------------------------------------

def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Same family/period structure, tiny dimensions, CPU-friendly."""
    np_ = len(cfg.layer_period)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=2 * np_,
        d_model=64,
        n_heads=4, n_kv_heads=max(1, min(cfg.n_kv_heads, 2)), d_head=16,
        d_ff=128, d_ff_expert=128 if cfg.d_ff_expert else 0,
        vocab_size=512,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        experts_per_token=min(cfg.experts_per_token, 2)
        if cfg.n_experts else 0,
        n_enc_layers=2 if cfg.n_enc_layers else 0,
        n_ctx_tokens=16 if cfg.n_ctx_tokens else 0,
        d_ctx=32 if cfg.d_ctx else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        ssm_chunk=8,
        window=min(cfg.window, 16) if cfg.window else None,
        dtype=torch.float32,
        moe_tp=False,
        # capacity high enough that smoke-scale dispatch never drops —
        # batched-vs-sequential drop patterns would legitimately diverge
        capacity_factor=8.0,
        remat=False,
    )
