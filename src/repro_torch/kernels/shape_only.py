"""The kernels' shape-only route, which the dry run takes
(`launch/dryrun.py`): under fake tensors (`FakeTensorMode`) or on the
meta device a wrapper has no data to launch on, so it calls one of the
custom ops below instead. Each op's fake implementation gives the
kernel's outputs (shapes and types, no values, nothing launched), and
its flop formula (`torch.utils.flop_counter`) the operations the kernel
itself runs — the numerator of its bound in PERF.md §2 — not those of
its plain version:

* `flash_fwd`: 4 B Hq dh P, P the (query, key) pairs the masks keep (the
  kernel skips key blocks above the diagonal and outside a window);
* `flash_bwd`: 10 B Hq dh P (the recomputed scores, dP, dS and the three
  products: 2.5 times the forward);
* `moe_fwd`: 6 n D F for n computed slots (the up, gate and down
  products);
* `moe_bwd`: 16 n D F (`ich_moe_bwd.backward_flops`);
* `scan_fwd`, `scan_bwd`: the SSD scan's chunked algebra on its shapes
  (`scan_forward_flops`, `scan_backward_flops`), at the heads the call
  holds (a rank's H/tp on a mesh); q.k once for every head when q and k
  are (B, S, 1, N);
* `slstm_fwd`, `slstm_bwd`: the sLSTM loop (not a kernel: a Python loop
  of small ops a step, which under fake tensors would take minutes at
  tens of thousands of steps) as one op: its S steps counted by formula
  (2 B H dh^2 a step forward for h r, 4 B H dh^2 backward), and what
  autograd keeps of its steps as one (B, S, 3, H, dh) float32 tensor (zr,
  c and tanh c a step; the h of every step is the output).

A real tensor never reaches these ops: given CPU tensors a wrapper runs
its plain version, given CUDA tensors it launches its kernel or raises.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.ich_moe.ich_moe_bwd import backward_flops


def shape_only(*tensors) -> bool:
    """True when a tensor is fake or on the meta device (no data)."""
    return any(t is not None and (t.device.type == "meta" or is_fake(t))
               for t in tensors)


def kept_pairs(Sq: int, Skv: int, *, causal: bool, window: int = 0,
               q_offset: int = 0) -> int:
    """(query, key) pairs the flash masks keep: query i at position
    q_offset + i keeps keys j < Skv with j <= its position when causal
    and j > its position - window when window > 0."""
    p = q_offset + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(p, Skv - 1) if causal else np.full(Sq, Skv - 1)
    lo = np.maximum(p - window + 1, 0) if window > 0 else np.zeros(Sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _never(*args, **kwargs):
    raise RuntimeError("a shape-only op ran on real tensors")


@torch.library.custom_op("repro_torch::flash_fwd", mutates_args=())
def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, window: int,
              q_offset: int) -> tuple[torch.Tensor, torch.Tensor]:
    _never()


@flash_fwd.register_fake
def _(q, k, v, causal, window, q_offset):
    B, Sq, Hq, _ = q.shape
    return torch.empty_like(q), q.new_empty((B, Hq, Sq), dtype=torch.float32)


@torch.library.custom_op("repro_torch::flash_bwd", mutates_args=())
def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor,
              causal: bool,
              window: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _never()


@flash_bwd.register_fake
def _(q, k, v, out, dout, lse, causal, window):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


@torch.library.custom_op("repro_torch::moe_fwd", mutates_args=())
def moe_fwd(x: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
            wo: torch.Tensor, n_slots: int) -> torch.Tensor:
    _never()


@moe_fwd.register_fake
def _(x, wi, wg, wo, n_slots):
    return torch.empty_like(x)


@torch.library.custom_op("repro_torch::moe_bwd", mutates_args=())
def moe_bwd(x: torch.Tensor, dy: torch.Tensor, w: torch.Tensor,
            wi: torch.Tensor, wg: torch.Tensor, wo: torch.Tensor,
            n_slots: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor, torch.Tensor]:
    _never()


@moe_bwd.register_fake
def _(x, dy, w, wi, wg, wo, n_slots):
    return (torch.empty_like(x), torch.empty_like(w), torch.empty_like(wi),
            torch.empty_like(wg), torch.empty_like(wo))


@torch.library.custom_op("repro_torch::scan_fwd", mutates_args=())
def scan_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             log_a: torch.Tensor, chunk: int, state: Optional[torch.Tensor]
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                        torch.Tensor]:
    _never()


@scan_fwd.register_fake
def _(q, k, v, log_a, chunk, state):
    B, S, H, Pd = v.shape
    N, nc = q.shape[3], -(-S // chunk)
    f32 = dict(dtype=torch.float32)
    # y, the final state, and the kernel's scratch: the state before each
    # chunk and each chunk's l (kept for the backward in training)
    return (torch.empty_like(v), v.new_empty((B, H, N, Pd), **f32),
            v.new_empty((B, H, nc, N, Pd), **f32),
            v.new_empty((B, H, nc, chunk), **f32))


@torch.library.custom_op("repro_torch::scan_bwd", mutates_args=())
def scan_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             dy: torch.Tensor, st: torch.Tensor, lc: torch.Tensor,
             chunk: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    _never()


@scan_bwd.register_fake
def _(q, k, v, dy, st, lc, chunk):
    return (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v),
            v.new_empty(v.shape[:3], dtype=torch.float32))


@torch.library.custom_op("repro_torch::slstm_fwd", mutates_args=())
def slstm_fwd(r: torch.Tensor, zs: torch.Tensor, og: torch.Tensor,
              ig: torch.Tensor, fg: torch.Tensor, h: torch.Tensor,
              c: torch.Tensor, keep: bool
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    _never()


@slstm_fwd.register_fake
def _(r, zs, og, ig, fg, h, c, keep):
    B, S, H, dh = zs.shape
    saved = (B, S, 3, H, dh) if keep else (0,)
    return (torch.empty_like(zs), torch.empty_like(h), torch.empty_like(c),
            zs.new_empty(saved))


@torch.library.custom_op("repro_torch::slstm_bwd", mutates_args=())
def slstm_bwd(r: torch.Tensor, zs: torch.Tensor, saved: torch.Tensor,
              dys: torch.Tensor, dh: torch.Tensor, dc: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    _never()


@slstm_bwd.register_fake
def _(r, zs, saved, dys, dh, dc):
    B, S, H, dh_ = zs.shape
    return (torch.empty_like(r), torch.empty_like(zs), torch.empty_like(zs),
            zs.new_empty((B, S, H)), zs.new_empty((B, S, H)),
            torch.empty_like(dh), torch.empty_like(dc))


def scan_forward_flops(B: int, S: int, H: int, N: int, Pd: int, chunk: int,
                       shared_qk: bool) -> int:
    """Operations of the SSD scan's chunked algebra on these shapes. Per
    chunk of length c (the last may be short) and its c(c+1)/2 causal
    pairs: 2N for each pair's q.k score, once for every head when q and k
    are shared by the heads; per head, 2Pd + 1 for each pair's decayed
    product with v, and 4 c N Pd for the inter-chunk term and the state
    update."""
    score = per_head = 0
    for t0 in range(0, S, chunk):
        c = min(chunk, S - t0)
        pairs = c * (c + 1) // 2
        score += pairs * 2 * N
        per_head += pairs * (2 * Pd + 1) + 4 * c * N * Pd
    return B * (score * (1 if shared_qk else H) + H * per_head)


def scan_backward_flops(B: int, S: int, H: int, N: int, Pd: int, chunk: int,
                        shared_qk: bool) -> int:
    """Operations of the scan's gradient on these shapes: per chunk and
    causal pair 2N for the q.k score (shared as in the forward); per head
    2Pd for each pair's dy.v, 2N each for its terms of dq and dk, 2Pd for
    its term of dv, and 8 c N Pd for the four products with a chunk state
    (dq's, dk's and dv's terms and the adjoint state)."""
    score = per_head = 0
    for t0 in range(0, S, chunk):
        c = min(chunk, S - t0)
        pairs = c * (c + 1) // 2
        score += pairs * 2 * N
        per_head += pairs * (4 * Pd + 4 * N) + 8 * c * N * Pd
    return B * (score * (1 if shared_qk else H) + H * per_head)


def _flash_flops(q_shape, k_shape, causal, window, q_offset=0) -> int:
    B, Sq, Hq, dh = q_shape
    return 4 * B * Hq * dh * kept_pairs(Sq, k_shape[1], causal=causal,
                                        window=window, q_offset=q_offset)


@register_flop_formula(torch.ops.repro_torch.flash_fwd)
def _(q_shape, k_shape, v_shape, causal, window, q_offset, *args,
      out_shape=None, **kwargs) -> int:
    return _flash_flops(q_shape, k_shape, causal, window, q_offset)


@register_flop_formula(torch.ops.repro_torch.flash_bwd)
def _(q_shape, k_shape, v_shape, out_shape_, dout_shape, lse_shape, causal,
      window, *args, out_shape=None, **kwargs) -> int:
    return 10 * _flash_flops(q_shape, k_shape, causal, window) // 4


@register_flop_formula(torch.ops.repro_torch.moe_fwd)
def _(x_shape, wi_shape, wg_shape, wo_shape, n_slots, *args,
      out_shape=None, **kwargs) -> int:
    return 6 * int(n_slots) * x_shape[-1] * wi_shape[-1]


@register_flop_formula(torch.ops.repro_torch.moe_bwd)
def _(x_shape, dy_shape, w_shape, wi_shape, wg_shape, wo_shape, n_slots,
      *args, out_shape=None, **kwargs) -> int:
    return backward_flops(n_slots, x_shape[-1], wi_shape[-1])


@register_flop_formula(torch.ops.repro_torch.scan_fwd)
def _(q_shape, k_shape, v_shape, la_shape, chunk, state_shape, *args,
      out_shape=None, **kwargs) -> int:
    B, S, H, Pd = v_shape
    return scan_forward_flops(B, S, H, q_shape[3], Pd, int(chunk),
                              q_shape[2] == 1 and H > 1)


@register_flop_formula(torch.ops.repro_torch.scan_bwd)
def _(q_shape, k_shape, v_shape, dy_shape, st_shape, lc_shape, chunk, *args,
      out_shape=None, **kwargs) -> int:
    B, S, H, Pd = v_shape
    return scan_backward_flops(B, S, H, q_shape[3], Pd, int(chunk),
                               q_shape[2] == 1 and H > 1)


@register_flop_formula(torch.ops.repro_torch.slstm_fwd)
def _(r_shape, zs_shape, *args, out_shape=None, **kwargs) -> int:
    B, S, H, dh = zs_shape
    return 2 * S * B * H * dh * dh


@register_flop_formula(torch.ops.repro_torch.slstm_bwd)
def _(r_shape, zs_shape, *args, out_shape=None, **kwargs) -> int:
    B, S, H, dh = zs_shape
    return 4 * S * B * H * dh * dh
