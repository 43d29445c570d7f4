"""Stand-ins for every input of the step a shape dictates — the port's
counterpart of `repro.launch.specs`: each rank's LOCAL tensors on the
meta device (shapes and types, no memory), at the placements' shapes
(`models.model.param_pspecs`, `cache_pspecs`, `train.train_step.
train_state_pspecs`), built from `init_params(..., device="meta")`. With
`dist` None they are the whole tensors of one device.

The batch splits over the batch axes: a train batch always (the
reference's `batch_pspec`; it must divide), a prefill or decode batch
when the batch ranks divide it, else every rank holds it whole (the
reference's `tok_b`).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models import model as M
from repro_torch.train import train_step as TS

META = torch.device("meta")


def _rows(batch: int, dist, *, always: bool = False) -> int:
    """This rank's rows of a global batch."""
    if dist is None:
        return batch
    if batch % dist.dp:
        if always:
            raise ValueError(f"a batch of {batch} rows does not split over "
                             f"{dist.dp} batch ranks")
        return batch
    return batch // dist.dp


def _empty(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def train_batch_specs(cfg: ArchConfig, shape: ShapeSpec, dist=None,
                      always: bool = True) -> dict:
    B, S = _rows(shape.global_batch, dist, always=always), shape.seq_len
    batch = {"tokens": _empty((B, S), torch.int32),
             "labels": _empty((B, S), torch.int32)}
    if cfg.family == "encdec":
        batch["frames"] = _empty((B, cfg.encoder_seq, cfg.d_model),
                                 torch.bfloat16)
    if cfg.family == "vlm":
        batch["patches"] = _empty((B, cfg.num_patches, cfg.d_model),
                                  torch.bfloat16)
    return batch


def prefill_batch_specs(cfg: ArchConfig, shape: ShapeSpec, dist=None):
    b = train_batch_specs(cfg, shape, dist, always=False)
    del b["labels"]
    return b


def decode_input_specs(cfg: ArchConfig, shape: ShapeSpec,
                       dtype=torch.bfloat16, dist=None):
    """(tokens (B, 1), this rank's cache, pos): pos is the last position
    (S - 1), so the step attends over the whole cache."""
    B = _rows(shape.global_batch, dist)
    cache = _tree(M.local_cache_specs(cfg, B, shape.seq_len, dtype, dist))
    return _empty((B, 1), torch.int32), cache, shape.seq_len - 1


def _tree(spec):
    if isinstance(spec, dict):
        return {k: _tree(v) for k, v in spec.items()}
    if isinstance(spec, list):
        return [_tree(v) for v in spec]
    shape, dtype = spec
    return _empty(shape, dtype)


def params_specs(cfg: ArchConfig, max_seq: int, dist=None):
    """The model with this rank's shards, on the meta device."""
    model = M.init_params(cfg, max_seq=max_seq, device=META)
    if dist is not None:
        M.shard_model(model, cfg, dist)
    return model


def state_specs(cfg: ArchConfig, max_seq: int, tcfg=None, dist=None) -> dict:
    """This rank's train state (`init_train_state(..., dist=)`) on the
    meta device."""
    return TS.init_train_state(cfg, 0, max_seq, tcfg or TS.TrainConfig(),
                               device=META, dist=dist)


def input_specs(cfg: ArchConfig, shape: ShapeSpec, dist=None,
                tcfg=None) -> dict:
    """All inputs of the step this shape runs, as this rank holds them."""
    if shape.kind == "train":
        return {"state": state_specs(cfg, shape.seq_len, tcfg, dist),
                "batch": train_batch_specs(cfg, shape, dist)}
    if shape.kind == "prefill":
        return {"params": params_specs(cfg, shape.seq_len, dist),
                "batch": prefill_batch_specs(cfg, shape, dist)}
    tokens, cache, pos = decode_input_specs(cfg, shape, dist=dist)
    return {"params": params_specs(cfg, shape.seq_len, dist),
            "tokens": tokens, "cache": cache, "pos": pos}
