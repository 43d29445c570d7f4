"""Carry state across from the reference package.

The system has no weights: its state is the lowered schedule and the
packed payload. Each function here takes a lowering of the reference as
numpy arrays — the `TileSchedule` (`item_id`, `width`, `rows_per_tile`),
its `WorkerShards` (`worker`, `block_perm`, `superstep`), the packed
payload and the slot-cost stream in the layout the reference's kernel
reads — and builds the port's op over exactly that lowering, so both
packages' kernels can be fed the same bytes:

* `spmv_op_from_reference` — `vals`/`cols` and the (T_pad, R) stream;
* `bfs_op_from_reference` — the all-ones `mask`/`cols` and the (T_pad, R)
  stream;
* `kmeans_op_from_reference` — no payload; the (p*S, R) stream in the
  shard layout;
* `moe_dispatch_op_from_reference` — the packed combine weights (`vals`)
  and token ids (`cols`) of a dispatch plan's CSR, the (T_pad, R) stream
  and the plan's per-expert kept token counts. The expert weights and
  activations are plain arrays the op takes at call time, in the
  reference's layouts (wi/wg (E, D, F), wo (E, F, D)).

A language model's state is its weights:

* `lm_params_from_reference` — the reference's `init_params` tree, as
  numpy arrays (nested dicts and lists), loaded by name into the port's
  model (`embed/tok` -> `embed.tok`, `blocks/1/mamba/in_x`,
  `shared_attn/attn/wq`, ...); a stacked model's leaves, stacked per
  segment along a leading layer axis (`segments/0/attn/wq` (L0, d,
  Hq*dh), `segments/1/moe/wi` (L1, E, d, F)), one slice a layer, the
  segments' layers one after the other (`layers.3.attn.wq`,
  `layers.<L0 + l>.moe.wi`); whisper's encoder stack the same way
  (`enc/attn/wq` (L_enc, d, Hq*dh) -> `enc.<l>.attn.wq`), its decoder's
  `segments/0/{lnx,xattn}` with the other decoder leaves, and its
  learned position table `embed/pos` (max_seq, d), whose rows set the
  port model's `max_seq`;
* `train_state_from_reference` — the reference's `init_train_state`
  pytree (numpy leaves): the parameters through the same name map, the
  AdamW moments (and bf16_params' float32 master copy) and the
  compression residuals by the same names, the step and the MoE
  capacity scales.

Nothing here imports the reference: the caller hands the arrays over.
"""
from __future__ import annotations

import numpy as np

import torch

from repro_torch.core.tiling import WorkerShards
from repro_torch.models.model import init_params
from repro_torch.sched.kernels import BfsOp, KMeansOp, MoeDispatchOp, SpmvOp
from repro_torch.train.train_step import cast_bf16, shard_state


def _shards(item_id, rows_per_tile, worker, block_perm, superstep):
    item_id = np.asarray(item_id, np.int32)
    if item_id.ndim != 2 or item_id.shape[1] != int(rows_per_tile):
        raise ValueError(f"item_id {item_id.shape} must be (T, "
                         f"{int(rows_per_tile)})")
    shards = WorkerShards(worker=np.asarray(worker, np.int32),
                          block_perm=np.asarray(block_perm, np.int32),
                          superstep=int(superstep))
    return item_id, shards


def _payload(item_id, width, superstep, vals, cols, slot_cost):
    """The flat payload and stream as the kernels take them; raises when
    their shapes disagree with the lowering."""
    vals = np.asarray(vals, np.float32)
    cols = np.asarray(cols, np.int32)
    slot_cost = np.asarray(slot_cost, np.float32)
    (T, R), W, B = item_id.shape, int(width), int(superstep)
    T_pad = -(-T // B) * B
    if vals.shape != (T_pad, R, W) or cols.shape != vals.shape \
            or slot_cost.shape != (T_pad, R):
        raise ValueError(
            f"lowering shapes disagree: item_id {item_id.shape}, payload "
            f"{vals.shape}, cols {cols.shape}, slot_cost {slot_cost.shape} "
            f"for R={R}, W={W}, B={B}")
    return vals, cols, slot_cost


def spmv_op_from_reference(*, item_id, width: int, rows_per_tile: int,
                           worker, block_perm, superstep: int, vals, cols,
                           slot_cost, n_rows: int, device=None) -> SpmvOp:
    """The port's `SpmvOp` over a lowering given as numpy arrays (see the
    module docstring). Raises when the arrays disagree on shape."""
    item_id, shards = _shards(item_id, rows_per_tile, worker, block_perm,
                              superstep)
    vals, cols, slot_cost = _payload(item_id, width, superstep, vals, cols,
                                     slot_cost)
    return SpmvOp.from_lowering(item_id, shards, vals, cols, slot_cost,
                                n_rows, device=device)


def bfs_op_from_reference(*, item_id, width: int, rows_per_tile: int,
                          worker, block_perm, superstep: int, mask, cols,
                          slot_cost, n_vertices: int, device=None) -> BfsOp:
    """The port's `BfsOp` over a lowering given as numpy arrays (see the
    module docstring). Raises when the arrays disagree on shape."""
    item_id, shards = _shards(item_id, rows_per_tile, worker, block_perm,
                              superstep)
    mask, cols, slot_cost = _payload(item_id, width, superstep, mask, cols,
                                     slot_cost)
    return BfsOp.from_lowering(item_id, shards, mask, cols, slot_cost,
                               n_vertices, device=device)


def kmeans_op_from_reference(*, item_id, rows_per_tile: int, worker,
                             block_perm, superstep: int, slot_cost,
                             n_points: int, device=None) -> KMeansOp:
    """The port's `KMeansOp` over a lowering given as numpy arrays, with
    `slot_cost` in the (p*S, R) shard layout the reference's K-Means op
    passes its kernel. Raises when the arrays disagree on shape."""
    item_id, shards = _shards(item_id, rows_per_tile, worker, block_perm,
                              superstep)
    return KMeansOp.from_lowering(item_id, shards,
                                  np.asarray(slot_cost, np.float32),
                                  n_points, device=device)


def moe_dispatch_op_from_reference(*, item_id, width: int,
                                   rows_per_tile: int, worker, block_perm,
                                   superstep: int, vals, cols, slot_cost,
                                   counts, n_tokens: int,
                                   device=None) -> MoeDispatchOp:
    """The port's `MoeDispatchOp` over a lowering given as numpy arrays
    (see the module docstring); `counts` are the plan's (E,) kept token
    counts. Raises when the arrays disagree on shape or with the counts."""
    item_id, shards = _shards(item_id, rows_per_tile, worker, block_perm,
                              superstep)
    vals, cols, slot_cost = _payload(item_id, width, superstep, vals, cols,
                                     slot_cost)
    return MoeDispatchOp.from_lowering(item_id, shards, vals, cols,
                                       slot_cost, np.asarray(counts),
                                       n_tokens, device=device)


def _flatten(tree, prefix: str = ""):
    """Leaves of a nested dict/list tree as ("a.b.0.c", array) pairs."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for key, sub in items:
        yield from _flatten(sub, f"{prefix}.{key}" if prefix else str(key))


def _unstack(stack: dict, prefix: str, first: int, label: str) -> tuple:
    """The leaves of one stack ({name: array with a leading layer axis})
    as one leaf a layer, `<prefix>.<first + l>.<name>`, and the stack's
    layer count. Raises when the leaves disagree on it."""
    counts = {len(arr) for arr in stack.values()}
    if len(counts) != 1:
        raise ValueError(f"{label}'s leaves disagree on their layer count: "
                         f"{sorted(counts)}")
    out = {f"{prefix}.{first + layer}.{rest}": sl
           for rest, arr in stack.items() for layer, sl in enumerate(arr)}
    return out, counts.pop()


def _unstack_segments(leaves: dict) -> dict:
    """Every segment's stacked leaves (`segments.<i>.<name>`, leading axis
    L_i) as one leaf a layer (`layers.<l>.<name>`), segment i's layers
    numbered from the sum of the earlier segments' L; an encoder's
    (`enc.<name>`, leading axis L_enc) as `enc.<l>.<name>`; other leaves
    as they are."""
    out, segments, enc = {}, {}, {}
    for name, arr in leaves.items():
        if name.startswith("segments."):
            i, rest = name[len("segments."):].split(".", 1)
            segments.setdefault(int(i), {})[rest] = np.asarray(arr)
        elif name.startswith("enc."):
            enc[name[len("enc."):]] = np.asarray(arr)
        else:
            out[name] = arr
    first = 0
    for i in sorted(segments):
        layers, count = _unstack(segments[i], "layers", first,
                                 f"segment {i}")
        out.update(layers)
        first += count
    if enc:
        out.update(_unstack(enc, "enc", 0, "the encoder")[0])
    return out


def _by_name(np_tree) -> dict:
    """A parameter-shaped reference tree as {port name: array}."""
    return _unstack_segments(dict(_flatten(np_tree)))


def lm_params_from_reference(cfg, np_params, device=None):
    """The port's model (`models.model.StackedLM`, `EncDecLM` or
    `HybridLM`) holding exactly the reference's weights: `np_params` is
    `repro.models.model.init_params`'s tree with numpy leaves (a learned
    position table's rows give the model's `max_seq`). Raises when a name
    or a shape disagrees."""
    pos = np_params.get("embed", {}).get("pos")
    model = init_params(cfg, max_seq=0 if pos is None else len(pos),
                        device=device)
    theirs = _by_name(np_params)
    ours = model.state_dict()
    if set(theirs) != set(ours):
        raise ValueError(f"parameter names disagree: only in the reference "
                         f"{sorted(set(theirs) - set(ours))}, only in the "
                         f"port {sorted(set(ours) - set(theirs))}")
    state = {}
    for name, arr in theirs.items():
        t = torch.from_numpy(np.array(arr, np.float32))
        if tuple(t.shape) != tuple(ours[name].shape):
            raise ValueError(f"{name}: reference shape {tuple(t.shape)}, "
                             f"port shape {tuple(ours[name].shape)}")
        state[name] = t
    model.load_state_dict(state, strict=True)
    return model


def train_state_from_reference(cfg, np_state, device=None,
                               dist=None) -> dict:
    """The port's train state (`train.train_step.init_train_state`'s
    layout) holding exactly the reference's `init_train_state(...)` tree
    given with numpy leaves: "params" through `lm_params_from_reference`
    (requiring grad; bfloat16 when the reference keeps a float32 master,
    as bf16_params does), "opt" {"m", "v"[, "master"]} by the port's
    parameter names (float32), "step" (int32), "cap_scales" and, when
    present, "grad_err". With `dist` (`launch.mesh.DistContext`) the
    calling rank's shards of every leaf's placement
    (`train.train_step.shard_state`). Raises when a
    name or shape disagrees."""
    model = lm_params_from_reference(cfg, np_state["params"], device=device)
    model.requires_grad_(True)
    dev = next(model.parameters()).device
    names = {n: tuple(p.shape) for n, p in model.named_parameters()}

    def tensors(tree) -> dict:
        out = {}
        for name, arr in _by_name(tree).items():
            if names.get(name) != np.shape(arr):
                raise ValueError(f"{name}: reference shape {np.shape(arr)}, "
                                 f"port shape {names.get(name)}")
            out[name] = torch.from_numpy(np.array(arr, np.float32)).to(dev)
        if set(out) != set(names):
            raise ValueError(f"parameter names disagree: "
                             f"{sorted(set(out) ^ set(names))}")
        return out

    opt = np_state["opt"]
    new_opt = {"m": tensors(opt["m"]), "v": tensors(opt["v"]),
               "step": torch.tensor(int(np.asarray(opt["step"])),
                                    dtype=torch.int32, device=dev)}
    if "master" in opt:
        new_opt["master"] = tensors(opt["master"])
        cast_bf16(model)
    state = {"params": model, "opt": new_opt,
             "cap_scales": torch.from_numpy(np.array(
                 np_state["cap_scales"], np.float32)).to(dev)}
    if "grad_err" in np_state:
        state["grad_err"] = tensors(np_state["grad_err"])
    if dist is None:
        return state
    return shard_state(cfg, state, dist)
