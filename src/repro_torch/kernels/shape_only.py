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
* `moe_bwd`: 16 n D F (`ich_moe_bwd.backward_flops`).

A real tensor never reaches these ops: given CPU tensors a wrapper runs
its plain version, given CUDA tensors it launches its kernel or raises.
"""
from __future__ import annotations

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
