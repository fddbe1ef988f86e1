"""Model configuration covering all assigned architecture families.

One frozen dataclass describes dense / MoE / SSM / hybrid / enc-dec / VLM
backbones; family-specific fields are simply unused elsewhere.  Exact
per-arch values live in ``repro_torch/configs/<id>.py``.  The fields and
properties are the JAX package's (``repro/models/common.py``);
:attr:`ModelConfig.param_dtype` is a torch dtype.  :func:`float32_bf16_reductions`
is the bf16 product precision that the serve and train launchers share.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: Optional[int] = None
    qkv_bias: bool = False
    mlp_act: str = "swiglu"  # swiglu | gelu | relu2
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    sliding_window: Optional[int] = None  # SWA width (h2o-danube)
    rope_theta: float = 10000.0
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    # layers with index < dense_prefix_layers use the dense MLP (deepseek-moe
    # keeps layer 0 dense)
    dense_prefix_layers: int = 0

    # --- SSM (Mamba2/SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv: int = 4
    ssm_groups: int = 1

    # --- hybrid (zamba2): shared attention block every k SSM layers ---
    hybrid_attn_every: int = 0

    # --- enc-dec (whisper) ---
    n_enc_layers: int = 0
    enc_seq: int = 1500  # precomputed frame embeddings (frontend stub)

    # --- vlm (pixtral): patch embeddings prepended (frontend stub) ---
    n_img_tokens: int = 0

    dtype: str = "bfloat16"
    vocab_pad_to: int = 256

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(1, self.n_heads))

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return (self.vocab + p - 1) // p * p

    @property
    def param_dtype(self) -> torch.dtype:
        dt = getattr(torch, self.dtype, None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"unknown dtype {self.dtype!r}")
        return dt

    @property
    def d_inner(self) -> int:  # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def block_kinds(self) -> Tuple[str, ...]:
        """Per-layer block type sequence for the decoder stack."""
        if self.family == "ssm":
            return ("ssm",) * self.n_layers
        if self.family == "hybrid":
            k = self.hybrid_attn_every or 6
            kinds = []
            for i in range(self.n_layers):
                kinds.append("ssm")
                if (i + 1) % k == 0:
                    kinds.append("shared_attn")
            return tuple(kinds)
        return ("attn",) * self.n_layers

    def n_flop_params(self) -> float:
        """Active parameter count N for MODEL_FLOPS = 6*N*D (MoE: activated)."""
        d, hd = self.d_model, self.hd
        attn = self.n_heads * hd * d + 2 * self.n_kv_heads * hd * d + self.n_heads * hd * d
        if self.mlp_act == "swiglu":
            dense_mlp = 3 * d * self.d_ff
        else:
            dense_mlp = 2 * d * self.d_ff
        per_layer = 0.0
        if self.family in ("dense", "vlm", "encdec"):
            per_layer = attn + dense_mlp
        elif self.family == "moe":
            act_ff = (self.top_k + self.n_shared_experts) * self.moe_d_ff
            moe_mlp = 3 * d * act_ff
            per_layer = attn + moe_mlp
        elif self.family == "ssm":
            di, ns = self.d_inner, self.ssm_state
            per_layer = d * (2 * di + 2 * self.ssm_groups * ns + self.ssm_heads) + di * d
        elif self.family == "hybrid":
            di, ns = self.d_inner, self.ssm_state
            ssm = d * (2 * di + 2 * self.ssm_groups * ns + self.ssm_heads) + di * d
            n_shared = self.n_layers // (self.hybrid_attn_every or 6)
            return self.n_layers * ssm + n_shared * (attn + dense_mlp) + 2 * d * self.padded_vocab
        total = self.n_layers * per_layer
        if self.family == "encdec":
            total += self.n_enc_layers * (attn + dense_mlp)
        total += 2 * d * self.padded_vocab  # embed + unembed
        return float(total)


@contextlib.contextmanager
def float32_bf16_reductions():
    """cuBLAS's reduced-precision reductions of bf16 products off for the
    block, then restored: the bf16 weight products accumulate in float32,
    as XLA's do (the flag is process-wide)."""
    saved = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = saved
