"""Analytic roofline cost model per (arch x shape x mesh) — the port's
copy of `repro.launch.costmodel`, rebuilt for the H100.

WHY ANALYTIC: the dry run (`launch/dryrun.py`) traces one rank's step
under fake tensors, so its operation count (`FlopCounterMode`) is exact
for what the port runs, but it has no clock: the roofline terms need the
model's structure and the mesh's layout, with every formula explicit and
unit-tested. `cell_cost`'s flops, hbm_bytes, wire_bytes and
useful_flops are the reference's formulas, unchanged (a test holds them
equal); what is the H100's:

  * `CellCost.wire_by_axis` splits wire_bytes by the mesh axis it
    crosses: "model" (the TP psums), "data" (the FSDP gathers and the
    gradient reduce), "pod" (the pod all-reduce); their sum is
    wire_bytes;
  * `terms()` charges "model" bytes at NVLink's rate (the axis stays in
    a node) and the rest at InfiniBand's, compute at the H100's bfloat16
    peak and memory at its HBM rate (`launch/mesh.py`);
  * `port_knobs(shape)` sets each lever from the code it describes.

Conventions (the reference's):
  * matmul FLOPs = 2*M*N*K; training multiplies by (fwd=1, bwd=2, remat=1) = 4
    (remat policy "nothing" recomputes the fwd in the bwd pass);
    attention adds one extra fwd (inner kv-scan checkpointing) = 5x fwd.
  * without causal_skip the full S^2 score matrix is charged (no block
    skipping).
  * MoE expert FLOPs are charged at the padded capacity buffer size
    (E_local * C_max slots per rank), not at the useful token count.
  * HBM bytes: parameter traffic (each local shard read once per fwd/bwd/
    remat pass + optimizer read/write), activation traffic approximated as
    12 bytes/elem per block boundary tensor (write + 2 reads, bf16+fp32 mix),
    KV-cache read/write for decode, gathered-weight traffic for FSDP.
  * collective bytes (wire, per device): FSDP all-gathers of bf16 weights
    (fwd + remat + bwd), grad reduce (reduce-scatter model: (g-1)/g), TP
    psums of block outputs, MoE psum per layer, embedding/logits gathers.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.launch.mesh import HBM_BW, IB_BW, NVLINK_BW, PEAK_FLOPS


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """pods x dp x tp ranks; the default is the reference's 16 x 16 (the
    port's production mesh is 32 x 8: `MeshShape(dp=32, tp=8)`)."""
    pods: int = 1
    dp: int = 16
    tp: int = 16

    @property
    def chips(self) -> int:
        return self.pods * self.dp * self.tp


@dataclasses.dataclass
class CellCost:
    flops: float           # per device, per step
    hbm_bytes: float       # per device, per step
    wire_bytes: float      # per device, per step
    useful_flops: float    # MODEL_FLOPS share per device
    wire_by_axis: dict = dataclasses.field(default_factory=dict)
    # wire_bytes by mesh axis ("data", "model", "pod"), summing to it

    def terms(self):
        """Seconds: compute at the bfloat16 peak, memory at the HBM rate,
        collectives with "model" bytes at NVLink's rate and the others at
        InfiniBand's."""
        wire = self.wire_by_axis or {"data": self.wire_bytes}
        return {
            "compute": self.flops / PEAK_FLOPS,
            "memory": self.hbm_bytes / HBM_BW,
            "collective": sum(b / (NVLINK_BW if axis == "model" else IB_BW)
                              for axis, b in wire.items()),
        }


# --------------------------------------------------------------------------
# per-block FLOPs for one token (fwd only, unsharded "global" counts)
# --------------------------------------------------------------------------

def _attn_proj_flops(cfg) -> float:
    d, dh = cfg.d_model, cfg.dh
    return 2.0 * d * (cfg.n_heads * dh + 2 * cfg.n_kv_heads * dh) + \
        2.0 * (cfg.n_heads * dh) * d


def _attn_score_flops(cfg, s_ctx: float) -> float:
    """per-token score+pv FLOPs against context length s_ctx."""
    return 4.0 * s_ctx * cfg.n_heads * cfg.dh


def _mlp_flops(cfg, f: int) -> float:
    mult = 3 if cfg.act == "swiglu" else 2
    return 2.0 * mult * cfg.d_model * f


def _mamba_flops(cfg) -> float:
    d = cfg.d_model
    d_in = cfg.mamba_expand * d
    N = cfg.ssm_state
    H = d_in // cfg.ssm_head_dim
    P = cfg.ssm_head_dim
    Q = cfg.ssm_chunk
    proj = 2.0 * d * (2 * d_in + 2 * N + H) + 2.0 * d_in * d
    # SSD per token: intra scores Q*(N+P) per head + state update N*P per head
    ssd = 2.0 * H * (Q * (N + P) + N * P)
    return proj + ssd


def _mlstm_flops(cfg) -> float:
    d = cfg.d_model
    d_in = cfg.mamba_expand * d
    H = cfg.n_heads
    dh = d_in // H
    Q = cfg.ssm_chunk
    proj = 2.0 * d * 2 * d_in + 3 * 2.0 * d_in * d_in + 2.0 * d_in * d
    intra = 2.0 * H * (Q * (dh + dh) + dh * dh)
    return proj + intra


def _slstm_flops(cfg) -> float:
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    return 2.0 * d * (2 * d + 2 * H) + 2.0 * H * dh * dh + 2.0 * d * d


def _layer_flops_per_token(cfg, kind: str, s_ctx: float) -> float:
    if kind in ("dense", "densffn", "moe", "enc", "dec", "A"):
        f = _attn_proj_flops(cfg) + _attn_score_flops(cfg, s_ctx)
        if kind == "dec":
            f += _attn_proj_flops(cfg) + _attn_score_flops(cfg, cfg.encoder_seq)
        if kind == "dense" or kind in ("enc", "dec", "A"):
            f += _mlp_flops(cfg, cfg.d_ff)
        elif kind == "densffn":
            f += _mlp_flops(cfg, cfg.dense_d_ff or cfg.d_ff)
        else:  # moe: capacity-padded expert compute + shared experts
            waste = getattr(cfg, "moe_cmax_factor", 2.0) * 1.25  # C_max x cf
            f += waste * cfg.experts_per_token * _mlp_flops(cfg, cfg.moe_d_ff)
            f += cfg.n_shared_experts * _mlp_flops(cfg, cfg.moe_d_ff)
            f += 2.0 * cfg.d_model * cfg.n_experts  # router
        return f
    if kind == "M":
        return _mamba_flops(cfg)
    if kind == "X":
        return _mlstm_flops(cfg)
    if kind == "S":
        return _slstm_flops(cfg)
    raise ValueError(kind)


def _layers(cfg) -> list[str]:
    if cfg.family in ("hybrid", "ssm"):
        return list(cfg.block_pattern)
    if cfg.family == "encdec":
        return ["dec"] * cfg.n_layers  # encoder handled separately
    from repro_torch.models.model import segments_of
    out = []
    for kind, cnt in segments_of(cfg):
        out += [kind] * cnt
    return out


def _param_bytes(cfg, dtype_bytes: float = 4.0) -> float:
    return cfg.param_count() * dtype_bytes


def _ssm_state_traffic(cfg, tokens_dev: float, chunk: int = None) -> float:
    """HBM roundtrips of the inter-chunk state of a chunked scan that
    stores it: 2 (read+write) * (tokens/Q) * H*P*N * 4B per recurrent
    layer. The scan kernel (`csrc/mamba_scan.cu`) keeps the state on chip
    => this term ~ 0 (`ssm_kernel`)."""
    if cfg.family not in ("hybrid", "ssm"):
        return 0.0
    Q = chunk or cfg.ssm_chunk
    d_in = cfg.mamba_expand * cfg.d_model
    total = 0.0
    for kind in cfg.block_pattern:
        if kind == "M":
            H = d_in // cfg.ssm_head_dim
            state = H * cfg.ssm_head_dim * cfg.ssm_state
        elif kind == "X":
            dh = d_in // cfg.n_heads
            state = cfg.n_heads * (dh + 1) * dh
        else:
            continue
        total += 2.0 * (tokens_dev / Q) * state * 4.0
    return total


def cell_cost(cfg: ArchConfig, shape: ShapeSpec, mesh: MeshShape = MeshShape(),
              *, causal_skip: bool = False, remat_factor: float = None,
              decode_fsdp: bool = True, bf16_gather: bool = False,
              ssm_kernel: bool = False) -> CellCost:
    """Analytic per-device cost for this cell.

    Knobs: causal_skip (the flash kernel skips key blocks above the
    diagonal), remat_factor (override the recompute multiplier),
    decode_fsdp (FSDP-sharded serving weights => per-step gathers),
    bf16_gather (cast before FSDP all-gather), ssm_kernel (the scan keeps
    its state on chip); `port_knobs` sets them as the port runs.
    """
    B, S = shape.global_batch, shape.seq_len
    chips = mesh.chips
    dp_all = mesh.pods * mesh.dp
    layers = _layers(cfg)
    V, D = cfg.padded_vocab, cfg.d_model

    if shape.kind == "train":
        T = B * S
        s_ctx = (S / 2.0) if causal_skip else float(S)
        fwd = sum(_layer_flops_per_token(cfg, k, s_ctx) for k in layers) * T
        if cfg.family == "encdec":
            fwd += cfg.encoder_layers * (
                _attn_proj_flops(cfg) + _attn_score_flops(cfg, cfg.encoder_seq)
                + _mlp_flops(cfg, cfg.d_ff)) * B * cfg.encoder_seq
        fwd += 2.0 * V * D * T  # logits
        # fwd(1) + bwd(2) + layer remat(1); attention inner checkpoint ~ +0.2
        rf = remat_factor if remat_factor is not None else 4.2
        flops_global = fwd * rf
        useful = 6.0 * cfg.active_param_count() * T
        # HBM: params fp32 read x3 (fwd/remat/bwd) + opt m,v read+write +
        # grads write+read; activations ~12B per elem per layer boundary
        pb = _param_bytes(cfg) / (mesh.tp * mesh.dp)  # local shard
        param_traffic = pb * (3 + 4 + 2)
        act = 12.0 * (T / dp_all) * D * (len(layers) + 2) * (1 + 1.0)  # +bwd
        gathered = (_param_bytes(cfg, 2.0 if bf16_gather else 4.0) / mesh.tp) * 3
        hbm = param_traffic + act + gathered
        if not ssm_kernel:
            hbm += _ssm_state_traffic(cfg, T / dp_all) * 2.0  # fwd + remat/bwd
        # wire: FSDP gathers x3 passes + grad reduce-scatter+allgather + TP
        # psums (2 per layer fwd, x2 bwd) + pod all-reduce
        wb = _param_bytes(cfg, 2.0 if bf16_gather else 4.0) / mesh.tp
        fsdp_gather = 3.0 * wb * (mesh.dp - 1) / mesh.dp
        # bf16 params => grads are bf16 at the reduce boundary too
        grad_reduce = 2.0 * (_param_bytes(cfg, 2.0 if bf16_gather else 4.0)
                             / mesh.tp) * (mesh.dp - 1) / mesh.dp
        tp_psum = 4.0 * 2.0 * (T / dp_all) * D * 2.0 * len(layers) * \
            (mesh.tp - 1) / mesh.tp / mesh.tp
        pod = 0.0
        if mesh.pods > 1:
            pod = 2.0 * _param_bytes(cfg) / (mesh.tp * mesh.dp) * \
                (mesh.pods - 1) / mesh.pods
        wire = fsdp_gather + grad_reduce + tp_psum + pod
        return CellCost(flops_global / chips, hbm, wire, useful / chips,
                        {"data": fsdp_gather + grad_reduce, "model": tp_psum,
                         "pod": pod})

    if shape.kind == "prefill":
        T = B * S
        s_ctx = (S / 2.0) if causal_skip else float(S)
        fwd = sum(_layer_flops_per_token(cfg, k, s_ctx) for k in layers) * T
        fwd += 2.0 * V * D * B  # last-token logits
        pb2 = _param_bytes(cfg, 2.0)
        hbm = pb2 / (mesh.tp * (mesh.dp if decode_fsdp else 1)) + \
            pb2 / mesh.tp + 12.0 * (T / dp_all) * D * len(layers) + \
            _kv_bytes(cfg, B, S) / chips
        if not ssm_kernel:
            hbm += _ssm_state_traffic(cfg, T / dp_all)
        fsdp_gather = (pb2 / mesh.tp) * (mesh.dp - 1) / mesh.dp if decode_fsdp else 0.0
        tp_psum = 2.0 * (T / dp_all) * D * 2.0 * len(layers) * \
            (mesh.tp - 1) / mesh.tp / mesh.tp
        return CellCost(fwd / chips, hbm, fsdp_gather + tp_psum,
                        2.0 * cfg.active_param_count() * T / chips,
                        {"data": fsdp_gather, "model": tp_psum})

    # decode: one token per row, context S
    s_ctx = float(min(S, cfg.attn_window) if cfg.attn_window else S)
    fwd = sum(_layer_flops_per_token(cfg, k, s_ctx) for k in layers) * B
    fwd += 2.0 * V * D * B
    wbytes = 4.0 if decode_fsdp else 2.0  # fp32 baseline vs bf16 serve-opt
    pb2 = _param_bytes(cfg, wbytes)
    kv = _kv_bytes(cfg, B, S)
    hbm = pb2 / mesh.tp + kv / chips + pb2 / (mesh.tp * (mesh.dp if decode_fsdp else 1))
    # decode weights: fp32 FSDP-sharded (baseline) or bf16 TP-only (serve-opt)
    if decode_fsdp:
        fsdp_gather = (_param_bytes(cfg, 4.0) / mesh.tp) * (mesh.dp - 1) / mesh.dp
    else:
        fsdp_gather = 0.0
    # seq-sharded decode attention merges softmax stats (tiny gathers,
    # models.attention.decode_attention_seqsharded): no cache all-gather
    tp_psum = 2.0 * B / dp_all * D * 2.0 * len(layers) * (mesh.tp - 1) / mesh.tp / mesh.tp
    return CellCost(fwd / chips, hbm, fsdp_gather + tp_psum,
                    2.0 * cfg.active_param_count() * B / chips,
                    {"data": fsdp_gather, "model": tp_psum})


def _kv_bytes(cfg, B: int, S: int) -> float:
    """global KV/state cache bytes (bf16 kv, fp32 ssm states)."""
    if cfg.family in ("hybrid", "ssm"):
        total = 0.0
        d_in = cfg.mamba_expand * cfg.d_model
        for kind in cfg.block_pattern:
            if kind == "A":
                w = min(S, cfg.attn_window) if cfg.attn_window else S
                total += 2.0 * B * w * cfg.n_kv_heads * cfg.dh * 2
            elif kind == "M":
                H = d_in // cfg.ssm_head_dim
                total += 4.0 * B * H * cfg.ssm_head_dim * cfg.ssm_state
            elif kind == "X":
                dh = d_in // cfg.n_heads
                total += 4.0 * B * cfg.n_heads * (dh + 1) * dh
            else:
                total += 4.0 * B * cfg.d_model * 2
        return total
    n_attn = cfg.n_layers
    kv = 2.0 * B * S * cfg.n_kv_heads * cfg.dh * 2 * n_attn
    if cfg.family == "encdec":
        kv += 2.0 * B * cfg.encoder_seq * cfg.n_kv_heads * cfg.dh * 2 * cfg.n_layers
    return kv


def port_knobs(shape: ShapeSpec) -> dict:
    """The levers as the port's code sets them, per shape kind:
    causal_skip — the flash kernel skips key blocks above the diagonal
    (`csrc/flash_attention.cu`, and its backward's causal-balanced grid);
    remat_factor 4.0 — remat "nothing" reruns each layer's forward once
    (fwd 1 + rerun 1 + bwd 2) and the flash backward recomputes its
    scores inside its own kernel (no extra attention pass);
    bf16_gather False — `gather_data` gathers the stored float32 weights;
    decode_fsdp True — serving gathers FSDP-split weights each step;
    ssm_kernel True — the scan kernel keeps its state on chip."""
    if shape.kind == "train":
        return dict(causal_skip=True, remat_factor=4.0, bf16_gather=False,
                    ssm_kernel=True)
    if shape.kind == "prefill":
        return dict(causal_skip=True, decode_fsdp=True, ssm_kernel=True)
    return dict(decode_fsdp=True, ssm_kernel=True)
