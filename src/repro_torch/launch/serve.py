"""Serving launcher — the port's counterpart of `repro.launch.serve`:
batched requests through the iCh chunked-prefill engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
      --requests 8 [--preset tiny|full] [--device cpu]

Draws the model from seed 0 and the prompts from numpy's seed 0, runs
`serve.engine.Engine.generate` on the card (`--device cpu`: every
kernel's plain version) and prints the reference's line. The "tiny"
preset is `launch.train.preset`'s (heads 64 wide).
"""
import argparse

import numpy as np

from repro_torch.configs import get_arch
from repro_torch.launch.train import preset
from repro_torch.models import model as M
from repro_torch.serve.engine import Engine, EngineConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--preset", default="tiny", choices=["tiny", "full"])
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = preset(get_arch(args.arch), args.preset)
    max_seq = args.prompt_len + args.new_tokens + 8
    params = M.init_params(cfg, 0, max_seq=max_seq, device=args.device)
    eng = Engine(cfg, params, EngineConfig(max_seq=max_seq),
                 device=args.device)
    prompts = np.random.default_rng(0).integers(
        1, cfg.vocab_size - 1, (args.requests, args.prompt_len)
    ).astype(np.int32)
    out, stats = eng.generate(prompts, n_new=args.new_tokens)
    print(f"[serve] {args.requests} reqs x {args.new_tokens} new tokens; "
          f"chunks {[c['chunk'] for c in stats['chunks']]}; "
          f"d={stats['d_final']}")


if __name__ == "__main__":
    main()
