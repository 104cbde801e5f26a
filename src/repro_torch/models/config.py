"""Model configuration for the unified LM family.

The port's copy of ``repro.models.config``: one dataclass covers all 10
assigned architectures (dense / MoE / SSM / hybrid / VLM / audio), with the
same fields and defaults.  Exact table values live in
``repro_torch/configs/*.py``.  ``param_dtype`` is a ``torch.dtype``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

__all__ = ["ModelConfig", "param_count", "active_param_count", "pad_to"]


def pad_to(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    n_shared_experts: int = 0       # kimi-k2 style always-on expert(s)
    # --- attention ---
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    ssm_conv: int = 4
    ssm_compute_dtype: str = "float32"   # bf16 matmuls in the SSD chunk (§Perf)
    # --- layer layout ---
    attn_every: int = 1             # hybrid: one attn block per this many layers (0 = attn-free)
    shared_attn_block: bool = False # zamba2: the interleaved attn block shares params
    cross_attn_every: int = 0       # vlm: one cross-attn block per this many layers
    n_codebooks: int = 0            # audio: parallel EnCodec codebook heads
    vision_patches: int = 1601      # vlm stub frontend: patches per image
    vision_dim: int = 1280
    # --- numerics / runtime ---
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    attn_impl: str = "chunked"      # chunked | pallas (the FA kernel on CUDA) | naive
    attn_q_chunk: int = 1024
    attn_kv_chunk: int = 512
    causal_skip: bool = False       # triangular block schedule (skip fully-masked kv blocks)
    moe_backend: str = "local_gather"   # local_gather | a2a | ring | dense
    moe_wire_dtype: Optional[str] = None
    remat: bool = True
    loss_chunk: int = 0             # 0 = unchunked cross-entropy
    # --- sharding knobs (consumed by parallel/rules.py) ---
    pad_heads_to: int = 16          # pad attention heads so TP divides; 0 = off
    pad_vocab_to: int = 16
    optimizer_dtype: str = "float32"   # adam moments; "bfloat16" for ≥90B archs
    sequence_parallel: bool = False    # SP for norm regions (hillclimb lever)
    serve_params_replicated: bool = False  # inference: no FSDP shard on params
                                           # (set per-cell by launch/steps.py
                                           # when param_bytes/mp fits HBM)

    # ------------------------------------------------------------------
    @property
    def hdim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def n_heads_padded(self) -> int:
        if self.pad_heads_to and self.n_heads % self.pad_heads_to:
            return pad_to(self.n_heads, self.pad_heads_to)
        return self.n_heads

    @property
    def vocab_padded(self) -> int:
        if self.pad_vocab_to and self.vocab_size % self.pad_vocab_to:
            return pad_to(self.vocab_size, self.pad_vocab_to)
        return self.vocab_size

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def param_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # layer layout -----------------------------------------------------
    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind, length n_layers."""
        kinds = []
        for i in range(self.n_layers):
            if self.family in ("ssm",):
                kinds.append("ssm")
            elif self.family == "hybrid":
                # one (possibly shared) attention block per `attn_every`
                if self.attn_every and (i + 1) % self.attn_every == 0:
                    kinds.append("attn_shared" if self.shared_attn_block else "attn")
                else:
                    kinds.append("ssm")
            elif self.family == "vlm":
                if self.cross_attn_every and (i + 1) % self.cross_attn_every == 0:
                    kinds.append("cross")
                else:
                    kinds.append("attn")
            else:
                kinds.append("attn")
        return tuple(kinds)

    def smoke(self) -> "ModelConfig":
        """A reduced same-family config that runs a step on 1 CPU device."""
        small = dict(
            n_layers=max(2, min(4, self.attn_every or 2, self.cross_attn_every or 2)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads else 4,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            head_dim=16,
            pad_heads_to=0,
            pad_vocab_to=0,
            remat=False,
        )
        if self.family == "hybrid":
            small["n_layers"] = 2 * (self.attn_every or 2)
        if self.family == "vlm":
            small["n_layers"] = 2 * (self.cross_attn_every or 2)
            small["vision_patches"] = 8
            small["vision_dim"] = 32
        if self.n_experts:
            small["n_experts"] = min(self.n_experts, 8)
            small["top_k"] = min(self.top_k, 2)
            small["d_ff"] = 64
        if self.ssm_state:
            small["ssm_state"] = 16
            small["ssm_headdim"] = 16
            small["ssm_chunk"] = 8
        if self.sliding_window:
            small["sliding_window"] = 16
        return self.replace(name=self.name + "-smoke", **small)


# ---------------------------------------------------------------------------
def _attn_params(cfg: ModelConfig) -> int:
    h, kv, dh, d = cfg.n_heads, cfg.n_kv_heads, cfg.hdim, cfg.d_model
    return d * h * dh + 2 * d * kv * dh + h * dh * d


def _mlp_params(cfg: ModelConfig, d_ff: int) -> int:
    return 3 * cfg.d_model * d_ff  # SwiGLU: gate, up, down


def _ssm_params(cfg: ModelConfig) -> int:
    d, di, n, hh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    # Wz, Wx, WB, WC, Wdt, out_proj, conv, A, D, dt_bias
    return d * di * 2 + d * n * 2 + d * hh + di * d + cfg.ssm_conv * (di + 2 * n) + 2 * hh + hh


def param_count(cfg: ModelConfig) -> int:
    """Total parameters (unpadded dims, embedding included)."""
    total = cfg.vocab_size * cfg.d_model  # embedding (tied LM head not double counted)
    total += cfg.vocab_size * cfg.d_model  # untied LM head
    kinds = cfg.layer_kinds()
    shared_counted = False
    for k in kinds:
        if k == "attn":
            total += _attn_params(cfg)
            if cfg.n_experts:
                total += cfg.d_model * cfg.n_experts                    # router
                total += cfg.n_experts * _mlp_params(cfg, cfg.d_ff)     # experts
                total += cfg.n_shared_experts * _mlp_params(cfg, cfg.d_ff)
            elif cfg.d_ff:
                total += _mlp_params(cfg, cfg.d_ff)
        elif k == "attn_shared":
            if not shared_counted:
                total += _attn_params(cfg) + (_mlp_params(cfg, cfg.d_ff) if cfg.d_ff else 0)
                shared_counted = True
        elif k == "cross":
            total += _attn_params(cfg) + (_mlp_params(cfg, cfg.d_ff) if cfg.d_ff else 0)
            total += cfg.vision_dim * cfg.d_model  # vision projection
        elif k == "ssm":
            total += _ssm_params(cfg)
    if cfg.n_codebooks:
        total += (cfg.n_codebooks - 1) * cfg.vocab_size * cfg.d_model  # extra heads
    return total


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: only routed experts)."""
    if not cfg.n_experts:
        return param_count(cfg)
    total = param_count(cfg)
    n_moe_layers = sum(1 for k in cfg.layer_kinds() if k == "attn")
    inactive = (cfg.n_experts - cfg.top_k) * _mlp_params(cfg, cfg.d_ff) * n_moe_layers
    return total - inactive
