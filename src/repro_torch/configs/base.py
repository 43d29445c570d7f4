"""Architecture + shape configuration: the port's copy of
`repro.configs.base` (`ArchConfig` with `dh`, `padded_vocab` and
`param_count`, and `ShapeSpec`). The parity tests hold the copy equal to
the original, field for field."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


# The four assigned LM shapes (decode_* and long_* lower serve_step).
SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None  # default d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm: str = "rmsnorm"  # rmsnorm | layernorm | nonparametric_ln
    act: str = "swiglu"  # swiglu | gelu
    tie_embeddings: bool = False

    # MoE
    moe: bool = False
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0  # per-expert FFN width (fine-grained for deepseek)
    dense_d_ff: int = 0  # FFN width of leading dense layers (deepseek layer 0)
    moe_layer_start: int = 0  # layers [0, start) use a dense FFN
    moe_cmax_factor: float = 2.0  # compiled expert buffer = factor * C_base

    # hybrid / ssm (zamba2 / xlstm)
    ssm_state: int = 0
    block_pattern: tuple = ()  # per-layer mixer kind: "A"ttn / "M"amba / "X"=mLSTM / "S"=sLSTM
    shared_attention: bool = False  # zamba2: one attn param set reused at every "A"
    ssm_head_dim: int = 64
    mamba_expand: int = 2
    conv_kernel: int = 4
    ssm_chunk: int = 256  # SSD/mLSTM chunk length (memory-term lever, §Perf)

    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0  # precomputed audio frames (stub frontend)

    # vlm (phi-3-vision)
    num_patches: int = 0  # precomputed patch embeddings (stub frontend)

    # long-context behaviour: "full" attention archs skip long_500k;
    # hybrids use a sliding window for their attention blocks.
    attn_window: int = 0  # 0 = full causal; >0 = sliding window

    # distribution knobs (overridable per run)
    scan_layers: bool = True  # stack homogeneous layers and lax.scan
    remat: bool = True
    remat_policy: str = "nothing"  # see models.model.REMAT_POLICIES
    train_microbatch: int = 1  # grad-accumulation steps at train_4k scale

    @property
    def dh(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Megatron-style vocab padding to a multiple of 256 so the embedding
        table shards evenly over the model axis."""
        return ((self.vocab_size + 255) // 256) * 256

    def supports(self, shape: ShapeSpec) -> bool:
        """long_500k needs sub-quadratic sequence mixing (DESIGN.md §5)."""
        if shape.name == "long_500k":
            return self.family in ("hybrid", "ssm")
        return True

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks), for roofline
        MODEL_FLOPS = 6*N*D and for sanity tests."""
        d, dh = self.d_model, self.dh
        V = self.padded_vocab
        n = V * d  # embedding
        if not self.tie_embeddings:
            n += V * d  # lm head

        def attn_params():
            qkv = d * (self.n_heads * dh) + 2 * d * (self.n_kv_heads * dh)
            if self.qkv_bias:
                qkv += self.n_heads * dh + 2 * self.n_kv_heads * dh
            return qkv + (self.n_heads * dh) * d

        def dense_ffn(f):
            mult = 3 if self.act == "swiglu" else 2
            return mult * d * f

        def norms():
            if self.norm == "nonparametric_ln":
                return 0
            w = 2 * d
            return w * (2 if self.norm == "layernorm" else 1)

        if self.family == "encdec":
            # encoder layers: self-attn + ffn; decoder: self + cross + ffn
            enc = self.encoder_layers * (attn_params() + dense_ffn(self.d_ff) + norms())
            dec = self.n_layers * (2 * attn_params() + dense_ffn(self.d_ff) + int(1.5 * norms()))
            return n + enc + dec

        if self.family in ("hybrid", "ssm"):
            total = n
            d_in = self.mamba_expand * d
            attn_done = False
            for kind in self.block_pattern:
                if kind == "A":
                    if self.shared_attention and attn_done:
                        continue
                    total += attn_params() + dense_ffn(self.d_ff) + norms()
                    attn_done = True
                elif kind == "M":  # mamba2
                    nheads_m = d_in // self.ssm_head_dim
                    total += d * (2 * d_in + 2 * self.ssm_state + nheads_m)  # in_proj
                    total += self.conv_kernel * (d_in + 2 * self.ssm_state)
                    total += 2 * nheads_m  # A, D
                    total += d_in * d  # out_proj
                    total += d  # norm
                elif kind in ("X", "S"):  # mLSTM / sLSTM
                    total += d * (2 * d_in) + 3 * d_in * self.n_heads  # proj + gates (approx)
                    total += 3 * d_in * d_in // self.n_heads if kind == "X" else 4 * d_in
                    total += d_in * d + d
            return total

        per_layer = attn_params() + norms()
        total = n
        for layer in range(self.n_layers):
            if self.moe and layer >= self.moe_layer_start:
                fe = self.moe_d_ff
                experts = (self.n_experts + self.n_shared_experts) * dense_ffn(fe) // 3 * 3
                experts = (self.n_experts + self.n_shared_experts) * (3 * d * fe if self.act == "swiglu" else 2 * d * fe)
                total += per_layer + experts + d * self.n_experts  # + router
            elif self.moe:
                total += per_layer + dense_ffn(self.dense_d_ff or self.d_ff)
            else:
                total += per_layer + dense_ffn(self.d_ff)
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top-k + shared experts)."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        fe = self.moe_d_ff
        per_tok_experts = (self.experts_per_token + self.n_shared_experts)
        all_experts = (self.n_experts + self.n_shared_experts)
        mult = 3 if self.act == "swiglu" else 2
        moe_layers = self.n_layers - self.moe_layer_start
        inactive = moe_layers * (all_experts - per_tok_experts) * mult * d * fe
        return self.param_count() - inactive
