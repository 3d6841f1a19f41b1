"""Model / shape / run configuration dataclasses.

Every assigned architecture is expressed as a ``ModelCfg`` built from
repeating *periods* of heterogeneous sublayers (attn / ssm, dense-FFN /
MoE-FFN), so a 72-layer hybrid compiles as a 9-iteration ``lax.scan`` over
stacked period parameters — HLO size stays O(period), not O(depth).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256  # SSD chunk length for the train/prefill scan

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_ssm_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    name: str
    n_layers: int          # decoder layers (total sublayer count)
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int              # dense FFN hidden (0 = no dense FFN, e.g. mamba2)
    vocab: int
    # --- layer pattern -----------------------------------------------------
    period: int = 1                       # layers per scanned period
    attn_every: tuple[int, ...] = (0,)    # in-period indices with attention
    ssm_every: tuple[int, ...] = ()       # in-period indices with SSM mixer
    moe_every: tuple[int, ...] = ()       # in-period indices with MoE FFN
    moe: MoECfg | None = None
    ssm: SSMCfg | None = None
    # --- encoder (enc-dec archs only) --------------------------------------
    n_enc_layers: int = 0
    enc_frontend: Literal["none", "stub_audio", "stub_patch"] = "none"
    # --- flavor -------------------------------------------------------------
    rope_theta: float = 1e4
    mrope_sections: tuple[int, int, int] | None = None  # qwen2-vl M-RoPE
    qkv_bias: bool = False
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # sub-quadratic sequence mixing available (SSM / hybrid)?
    # (full-attention archs skip the long_500k cell — DESIGN.md)
    # derived below.

    def __post_init__(self) -> None:
        if self.n_layers % self.period:
            raise ValueError(f"{self.name}: n_layers % period != 0")
        for idx_set in (self.attn_every, self.ssm_every, self.moe_every):
            if any(i >= self.period for i in idx_set):
                raise ValueError(f"{self.name}: pattern index out of period")
        if set(self.attn_every) & set(self.ssm_every):
            raise ValueError(f"{self.name}: a layer cannot be attn and ssm")
        if len(set(self.attn_every) | set(self.ssm_every)) != self.period:
            raise ValueError(f"{self.name}: every layer needs a mixer")

    # --- derived -------------------------------------------------------------
    @property
    def n_periods(self) -> int:
        return self.n_layers // self.period

    @property
    def sub_quadratic(self) -> bool:
        return len(self.ssm_every) > 0

    @property
    def attention_free(self) -> bool:
        return len(self.attn_every) == 0

    @property
    def is_enc_dec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up for 16-way tensor-parallel sharding."""
        return -(-self.vocab // 16) * 16

    def layer_kind(self, l: int) -> tuple[str, str]:
        """(mixer, ffn) for absolute layer index l."""
        i = l % self.period
        mixer = "attn" if i in self.attn_every else "ssm"
        ffn = "moe" if i in self.moe_every else ("dense" if self.d_ff else "none")
        return mixer, ffn

    # --- parameter counts (for roofline MODEL_FLOPS and HBM budgeting) ------
    def param_count(self) -> tuple[int, int]:
        """(total_params, active_params_per_token)."""
        d = self.d_model
        total = active = 0
        emb = self.vocab_padded * d
        total += emb * (1 if self.tie_embeddings else 2)
        active += emb * (1 if self.tie_embeddings else 2)

        def attn_params() -> int:
            qkv = d * (self.n_heads + 2 * self.n_kv_heads) * self.d_head
            if self.qkv_bias:
                qkv += (self.n_heads + 2 * self.n_kv_heads) * self.d_head
            return qkv + self.n_heads * self.d_head * d

        def ssm_params() -> int:
            assert self.ssm is not None
            di = self.ssm.d_inner(d)
            gn = self.ssm.n_groups * self.ssm.d_state
            nh = self.ssm.n_ssm_heads(d)
            proj_in = d * (2 * di + 2 * gn + nh)
            conv = (di + 2 * gn) * self.ssm.d_conv
            extra = nh * 3  # A_log, D, dt_bias
            return proj_in + conv + extra + di * d

        def dense_ffn() -> int:
            return 3 * d * self.d_ff

        def moe_ffn() -> tuple[int, int]:
            assert self.moe is not None
            per_expert = 3 * d * self.moe.d_ff_expert
            router = d * self.moe.n_experts
            tot = per_expert * self.moe.n_experts + router
            act = per_expert * self.moe.top_k + router
            return tot, act

        n_all_layers = self.n_layers + self.n_enc_layers
        for l in range(self.n_layers):
            mixer, ffn = self.layer_kind(l)
            p = attn_params() if mixer == "attn" else ssm_params()
            total += p
            active += p
            if ffn == "dense":
                total += dense_ffn()
                active += dense_ffn()
            elif ffn == "moe":
                t, a = moe_ffn()
                total += t
                active += a
        for _ in range(self.n_enc_layers):  # encoder: attn + dense ffn + cross
            p = attn_params() + dense_ffn()
            total += p
            active += p
        if self.is_enc_dec:  # decoder cross-attention per decoder layer
            for _ in range(self.n_layers):
                total += attn_params()
                active += attn_params()
        del n_all_layers
        return total, active


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPE_GRID: dict[str, ShapeCfg] = {
    "train_4k": ShapeCfg("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524_288, 1, "decode"),
}


def applicable_shapes(cfg: ModelCfg) -> list[str]:
    """The spec's skip rules: long_500k only for sub-quadratic archs."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        names.append("long_500k")
    return names
