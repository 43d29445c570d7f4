"""End-to-end training on the PyTorch port: data pipeline (iCh
dispatcher) -> train_step (AdamW, remat, MoE iCh balancer) -> async
checkpoints -> auto-resume.

  PYTHONPATH=src python examples/torch_train_lm.py --steps 60 --device cpu
  PYTHONPATH=src python examples/torch_train_lm.py --arch olmoe-1b-7b \
      --preset 100m --steps 300                           # on the card

Crash-recovery demo: run with --failure-at 30, rerun the same command, and
the trainer resumes from the published checkpoint. The "tiny" preset is
`repro_torch.launch.train.preset`'s (the reference's reduced config with
heads 64 wide, which the flash kernels take); "100m" is the reference's.
"""
import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import get_arch, reduced
from repro_torch.launch.train import preset
from repro_torch.train.trainer import InjectedFailure, RunConfig, train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--preset", default="tiny",
                    choices=["tiny", "100m", "full"])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt_example"))
    ap.add_argument("--failure-at", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.preset == "100m":
        cfg = dataclasses.replace(
            reduced(cfg), n_layers=8, d_model=768, n_heads=12,
            n_kv_heads=12 if cfg.n_kv_heads == cfg.n_heads else 4,
            d_ff=3072, vocab_size=32000)
    else:
        cfg = preset(cfg, args.preset)
    run = RunConfig(steps=args.steps, batch=args.batch, seq=args.seq,
                    ckpt_dir=args.ckpt_dir, failure_at=args.failure_at)
    try:
        state, losses = train(cfg, run, device=args.device)
        print(f"done: loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    except InjectedFailure as e:
        print(f"crashed as requested: {e}; rerun to resume")


if __name__ == "__main__":
    main()
