"""Roofline analysis — the port's counterpart of `repro.launch.roofline`.

Reads the port's dry-run records (`launch/dryrun.py`) and derives, per
(arch x shape) on the production mesh (32 x 8 H100s, or 2 x 32 x 8):

  compute term    = FLOPs a rank / PEAK_FLOPS (bfloat16)           [s]
  memory term     = HBM bytes a rank / HBM_BW                      [s]
  collective term = "model" wire bytes / NVLINK_BW
                    + the other axes' wire bytes / IB_BW           [s]

from the ANALYTIC cost model (`launch/costmodel.py`), with the H100's
constants (`launch/mesh.py`). Also MODEL_FLOPS = 6*N*D (train) or 2*N*D
(inference; MoE: active N) against the model's FLOPs, the dominant term,
the roofline fraction = compute term / max(terms), and whether the
rank's argument + temp bytes from the record fit HBM_BYTES. The record
also holds the traced step's own operation count (`hlo_flops_measured`
keeps the reference's column name). `--opt` applies `port_knobs`, the
levers as the port's code sets them.

Usage: PYTHONPATH=src python -m repro_torch.launch.roofline
       [--dir results/dryrun_torch] [--mesh 32x8] [--csv out.csv]
       [--markdown] [--opt]
"""
from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch.costmodel import MeshShape, cell_cost, port_knobs
from repro_torch.launch.mesh import HBM_BYTES, PEAK_FLOPS

MESHES = {"32x8": MeshShape(pods=1, dp=32, tp=8),
          "2x32x8": MeshShape(pods=2, dp=32, tp=8)}


def tokens_of(shape) -> int:
    if shape.kind == "train":
        return shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return shape.global_batch * shape.seq_len
    return shape.global_batch  # decode: one token per row


def model_flops(arch, shape) -> float:
    """6*N*D for train, 2*N*D for inference (fwd only); MoE uses active N."""
    n = arch.active_param_count()
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n * tokens_of(shape)


def analyze(rec: dict, cmax: float = None, **knobs) -> dict:
    """Roofline terms from the analytic cost model (`launch/costmodel.py`);
    the dry-run record supplies the memory fit, the traced operation count
    and the collective inventory."""
    import dataclasses as _dc
    arch = ARCHS[rec["arch"]]
    if cmax is not None and arch.moe:
        arch = _dc.replace(arch, moe_cmax_factor=cmax)
    shape = SHAPES[rec["shape"]]
    mesh = MESHES[rec["mesh"]]
    cost = cell_cost(arch, shape, mesh, **knobs)
    terms = cost.terms()
    dom = max(terms, key=terms.get)
    t_bound = max(terms.values())
    m = rec["memory"]
    # the port's temp bytes already hold the step's new outputs; the
    # donated ones are arguments
    mem_total = m["argument_bytes"] + m["temp_bytes"]
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "status": rec["status"],
        "t_compute_s": terms["compute"], "t_memory_s": terms["memory"],
        "t_collective_s": terms["collective"],
        "dominant": dom,
        "roofline_fraction": (terms["compute"] / t_bound) if t_bound > 0 else 0.0,
        "model_flops": cost.useful_flops * mesh.chips,
        "hlo_flops_measured": rec["cost"].get("flops", 0.0),
        "useful_flops_ratio": cost.useful_flops / cost.flops if cost.flops else 0.0,
        "mem_per_dev_bytes": mem_total,
        "fits_hbm": mem_total <= HBM_BYTES,
        "step_time_bound_s": t_bound,
        "mfu_bound": (cost.useful_flops / PEAK_FLOPS) / t_bound if t_bound > 0 else 0.0,
    }


def bottleneck_note(row: dict) -> str:
    d = row["dominant"]
    if d == "collective":
        return ("overlap/shrink collectives: bucket and overlap the gradient "
                "reduce, bfloat16 before the FSDP gather, sequence-parallel TP")
    if d == "memory":
        return ("raise arithmetic intensity: fuse the elementwise work, "
                "larger per-step tile reuse, quantized KV")
    return ("compute-bound: cut non-useful FLOPs (remat policy, causal block "
            "skipping, masked-expert waste) to close useful-ratio gap")


def load(dir_: str, mesh: str, opt: bool = False):
    rows = []
    for f in sorted(pathlib.Path(dir_).glob("*.json")):
        rec = json.loads(f.read_text())
        if rec["mesh"] != mesh:
            continue
        if rec["status"] != "OK":
            rows.append({"arch": rec["arch"], "shape": rec["shape"],
                         "mesh": rec["mesh"], "status": rec["status"]})
            continue
        knobs = port_knobs(SHAPES[rec["shape"]]) if opt else {}
        rows.append(analyze(rec, **knobs))
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun_torch")
    ap.add_argument("--mesh", default="32x8", choices=sorted(MESHES))
    ap.add_argument("--csv", default="results/roofline_torch.csv")
    ap.add_argument("--markdown", action="store_true")
    ap.add_argument("--opt", action="store_true",
                    help="apply the levers as the port sets them (port_knobs)")
    args = ap.parse_args()
    rows = load(args.dir, args.mesh, opt=args.opt)

    hdr = ("arch,shape,status,t_compute_ms,t_memory_ms,t_collective_ms,"
           "dominant,roofline_fraction,useful_flops_ratio,mfu_bound,"
           "mem_per_dev_GiB,fits_hbm")
    lines = [hdr]
    for r in rows:
        if r["status"] != "OK":
            lines.append(f"{r['arch']},{r['shape']},{r['status']},,,,,,,,,")
            continue
        lines.append(
            f"{r['arch']},{r['shape']},OK,"
            f"{1e3*r['t_compute_s']:.3f},{1e3*r['t_memory_s']:.3f},"
            f"{1e3*r['t_collective_s']:.3f},{r['dominant']},"
            f"{r['roofline_fraction']:.3f},{r['useful_flops_ratio']:.3f},"
            f"{r['mfu_bound']:.3f},{r['mem_per_dev_bytes']/2**30:.2f},"
            f"{r['fits_hbm']}")
    out = "\n".join(lines)
    print(out)
    if args.csv:
        p = pathlib.Path(args.csv)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(out + "\n")
    if args.markdown:
        print()
        print("| arch | shape | compute | memory | collective | dominant | "
              "roofline frac | useful FLOPs | note |")
        print("|---|---|---|---|---|---|---|---|---|")
        for r in rows:
            if r["status"] != "OK":
                print(f"| {r['arch']} | {r['shape']} | — | — | — | "
                      f"{r['status']} | — | — | |")
                continue
            print(f"| {r['arch']} | {r['shape']} | {1e3*r['t_compute_s']:.2f}ms"
                  f" | {1e3*r['t_memory_s']:.2f}ms | {1e3*r['t_collective_s']:.2f}ms"
                  f" | {r['dominant']} | {r['roofline_fraction']:.2f} | "
                  f"{r['useful_flops_ratio']:.2f} | {bottleneck_note(r)[:60]} |")


if __name__ == "__main__":
    main()
