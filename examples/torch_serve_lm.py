"""Batched serving with iCh-adaptive chunked prefill on the PyTorch port.

  PYTHONPATH=src python examples/torch_serve_lm.py --arch qwen2-1.5b \
      [--device cpu]

Watch the chunk log: the engine classifies each prefill chunk's measured
token throughput against the running mean band (paper eqs. 1-8) and adapts
the chunk divisor d — the serving-side realization of iCh. The model is
the "tiny" preset (`repro_torch.launch.train.preset`: the reference's
reduced config with heads 64 wide, which the flash kernels take), drawn
from seed 0, on the card (`--device cpu`: every kernel's plain version).
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
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=192)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = preset(get_arch(args.arch), "tiny")
    params = M.init_params(cfg, 0, max_seq=512, device=args.device)
    eng = Engine(cfg, params,
                 EngineConfig(max_seq=args.prompt_len + args.new_tokens + 8),
                 device=args.device)
    prompts = np.random.default_rng(0).integers(
        1, cfg.vocab_size - 1, (args.batch, args.prompt_len)).astype(np.int32)
    out, stats = eng.generate(prompts, n_new=args.new_tokens)
    print("generated ids:\n", out)
    print("prefill chunk log (iCh adaptation):")
    for e in stats["chunks"]:
        print(f"  chunk={e['chunk']:4d} dt={e['dt']*1e3:7.1f}ms d={e['d']:.2f}")
    print("final divisor d:", stats["d_final"])


if __name__ == "__main__":
    main()
