"""ArchConfig of the port (counterpart of ``repro.configs.base``).

Slice 1 carries the decoder-only dense transformer: RMSNorm, RoPE, GQA
attention and a SwiGLU MLP.  Field names and defaults follow the reference
so one architecture's numbers read the same in both packages; the fields of
families and features not ported yet are left out.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.formats import format_for
from repro_torch.core.goldschmidt import target_bits_for
from repro_torch.core.policy import NumericsPolicy


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # None -> d_model // n_heads
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"  # activation dtype
    param_dtype: str = "float32"
    # numerics: the paper's technique; gs_p_bits/gs_iters left None derive
    # the (ROM width, pass count) pair from the compute dtype
    policy_mode: str = "gs_feedback"  # exact | gs_pipelined | gs_feedback
    gs_p_bits: Optional[int] = None
    gs_iters: Optional[int] = None
    quant: str = "none"  # none | int8: int8 weights and KV, fixed-point datapath
    max_seq: int = 4096

    def __post_init__(self):
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"{self.name}: heads {self.n_heads} % kv {self.n_kv_heads}")

    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        """``dtype`` as a torch dtype: activations and the KV cache."""
        return getattr(torch, self.dtype)

    def policy(self) -> NumericsPolicy:
        """Model-stack policy: the accuracy budget is the COMPUTE dtype;
        ``quant="int8"`` adds the fixed-point format of the int8 route."""
        fmt = None
        if self.quant != "none":
            if self.quant != "int8":
                raise ValueError(f"unknown quant mode {self.quant!r}")
            fmt = format_for("int8")
        return NumericsPolicy(
            mode=self.policy_mode, p_bits=self.gs_p_bits, iters=self.gs_iters,
            target_bits=target_bits_for(self.dtype), fmt=fmt)

    def optimizer_policy(self) -> NumericsPolicy:
        """Optimizer policy: the accuracy budget is the PARAM/state dtype, so
        f32 training keeps the (7, 2) datapath whatever the activations."""
        return NumericsPolicy(
            mode=self.policy_mode, p_bits=self.gs_p_bits, iters=self.gs_iters,
            target_bits=target_bits_for(self.param_dtype))
