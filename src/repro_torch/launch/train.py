"""Training launcher — the port's counterpart of `repro.launch.train`:

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
      --steps 100 [--preset tiny|full] [--ckpt-dir DIR] [--device cpu]

Runs `train.trainer.train` on the card (`--device cpu`: every kernel's
plain version) and prints the first and last losses. Like the
reference's, it passes no mesh: `train(..., mesh=)` is the library's
(`launch/mesh.py`). A run resumes from the newest checkpoint in
`--ckpt-dir`.

The "tiny" preset is the reference's `reduced(cfg)` with heads of
TINY_HEAD_DIM: the reference's tiny heads are 16 wide, and the port's
flash-attention kernels are built for heads of 64, 96 and 128, so its
d_model is TINY_HEAD_DIM times the reduced head count (the same on the
card and the CPU).
"""
import argparse
import os
import tempfile

from repro_torch.configs import get_arch, reduced
from repro_torch.train.train_step import TrainConfig
from repro_torch.train.trainer import RunConfig, train

TINY_HEAD_DIM = 64


def preset(cfg, name: str):
    """`cfg` itself ("full"), or its "tiny" cut: `reduced` with heads of
    TINY_HEAD_DIM."""
    if name == "full":
        return cfg
    return reduced(cfg, d_model=TINY_HEAD_DIM * reduced(cfg).n_heads)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--preset", default="tiny", choices=["tiny", "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--bf16-params", action="store_true")
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = preset(get_arch(args.arch), args.preset)
    tcfg = TrainConfig(bf16_params=args.bf16_params,
                       grad_compress=args.grad_compress,
                       microbatch=args.microbatch)
    run = RunConfig(steps=args.steps, batch=args.batch, seq=args.seq,
                    ckpt_dir=args.ckpt_dir)
    _, losses = train(cfg, run, tcfg, device=args.device)
    print(f"[train] {args.arch}: loss {losses[0]:.3f} -> {losses[-1]:.3f}")


if __name__ == "__main__":
    main()
