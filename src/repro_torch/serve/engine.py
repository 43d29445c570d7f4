"""Serving engine of the port with iCh-adaptive chunked prefill — the
counterpart of `repro.serve.engine` for the hybrid (Zamba2) and ssm
(xLSTM) families.

Prefill runs in chunks whose size is the iCh chunk: after each chunk the
engine classifies its measured token throughput against the running mean
band (mu +- eps*mu, paper eqs. 1-8) and adapts the divisor d as
`adapt_d` does.

* ssm family: incremental. Each chunk feeds only its own tokens through
  `models.model.prefill_extend` from the block states the last chunk left
  — O(chunk) work a chunk — with chunk boundaries on multiples of the
  one-shot prefill's scan-block length Q = min(cfg.ssm_chunk, S)
  (`_ssm_q`), so every chunk replays exactly the scan steps of a one-shot
  prefill and the last logits and states are its bits.
* hybrid family: a hybrid model's attention cache does not extend
  incrementally, so each chunk re-runs the whole prefix — quadratic in the
  prompt — and every such chunk is counted in `Engine.n_prefill_fallbacks`,
  as the reference counts it. The last chunk is a one-shot prefill of the
  whole prompt, so its logits and cache are those of one.

Runs are float32 end to end, as the reference's `Engine` runs them. The
per-request batcher surface (`start_request`, `prefill_chunk_step`,
`decode_one`) comes with ROADMAP.md queue 1 item 2.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import welford as W
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.sched.defaults import ICH_EPS


@dataclasses.dataclass
class EngineConfig:
    max_seq: int = 512
    eps: float = ICH_EPS       # iCh band (unified default)
    init_divisor: float = 4.0  # d_0: first chunk = prompt_len / d_0
    min_chunk: int = 16


class Engine:
    """`Engine(cfg, params, ecfg, device=None)`: `params` is the model
    (`models.model.HybridLM`) on `device` (None = the card; raises without
    CUDA). Prefill is incremental when `models.model.extend_cache_specs_ok`
    says the config's states extend (the ssm family), else a prefix rerun
    per chunk."""

    def __init__(self, cfg, params, ecfg: Optional[EngineConfig] = None, *,
                 device=None):
        self.device = resolve_device(device)
        M._check_family(cfg)
        devs = {p.device for p in params.parameters()}
        if any(d.type != self.device.type for d in devs):
            raise ValueError(f"params lie on {sorted(map(str, devs))}, the "
                             f"engine runs on {self.device}")
        self.cfg, self.params = cfg, params
        self.ecfg = ecfg if ecfg is not None else EngineConfig()
        self.incremental = M.extend_cache_specs_ok(cfg)
        # every prefix-rerun chunk (hybrid) is counted: the O(n^2) path
        # must be visible, never silent
        self.n_prefill_fallbacks = 0
        # iCh state: divisor d + completed-token throughputs
        self.d = self.ecfg.init_divisor
        self.ks: list[float] = []

    def _prefill(self, tokens: torch.Tensor):
        return M.prefill(self.cfg, self.params, {"tokens": tokens},
                         dtype=torch.float32)

    def _decode(self, tok, cache, pos: int):
        return M.decode_step(self.cfg, self.params, tok, cache, pos,
                             dtype=torch.float32)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---------------- iCh chunked prefill ----------------
    def _ssm_q(self, prompt_len: int) -> int:
        """Scan-block quantum of an incremental (ssm) prefill. The one-shot
        prefill scans in Q = min(cfg.ssm_chunk, S) blocks; incremental
        chunk boundaries must land on multiples of Q to replay the same
        scan steps (bit identity, see `models.model.prefill_extend`)."""
        return min(self.cfg.ssm_chunk, int(prompt_len))

    def _next_chunk(self, remaining: int, q: Optional[int] = None) -> int:
        c = max(self.ecfg.min_chunk, int(np.ceil(remaining / self.d)))
        if q:
            c = -(-c // q) * q  # round up to the ssm scan-block quantum
        return min(c, remaining)

    def _adapt(self, tokens_done: int, dt: float):
        thr = tokens_done / max(dt, 1e-6)
        self.ks.append(thr)
        mu, delta = W.ich_band(np.asarray(self.ks[-16:]), self.ecfg.eps)
        cls = W.classify(thr, mu, delta)
        self.d = W.adapt_d(self.d, cls, d_min=1.0, d_max=64.0)

    def prefill_chunked(self, tokens: np.ndarray):
        """tokens (B, S_prompt). Returns (last logits, cache, chunk log).
        Each chunk's time ends in a synchronize, so it is the card's."""
        toks = torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                               device=self.device)
        B, S = toks.shape
        log = []
        done = 0
        logits = None
        q = self._ssm_q(S) if self.incremental else None
        cache = (M.empty_extend_cache(self.cfg, B, S, dtype=torch.float32,
                                      device=self.device)
                 if self.incremental else None)
        while done < S:
            c = self._next_chunk(S - done, q)
            t0 = time.perf_counter()
            if self.incremental:
                # feed ONLY the chunk from the last chunk's states
                logits, cache = M.prefill_extend(
                    self.cfg, self.params, toks[:, done: done + c], cache,
                    done, dtype=torch.float32, ssm_chunk=q)
            else:
                # re-run the prefix — O(n^2), counted so the fallback can
                # never hide in the logs
                self.n_prefill_fallbacks += 1
                logits, cache = self._prefill(toks[:, : done + c])
            self._sync()
            dt = time.perf_counter() - t0
            self._adapt(c * B, dt)
            log.append({"chunk": c, "dt": dt, "d": self.d})
            done += c
        return logits, cache, log

    def start_request(self, st) -> None:
        if not self.incremental:
            raise NotImplementedError(
                f"continuous batching needs prefill_extend; family "
                f"{self.cfg.family!r} caches don't extend incrementally")
        raise NotImplementedError(
            "the per-request batcher surface (start_request, "
            "prefill_chunk_step, decode_one) comes with ROADMAP.md queue 1 "
            "item 2")

    # ---------------- decode ----------------
    def _cache_len(self) -> int:
        w = self.cfg.attn_window
        return min(self.ecfg.max_seq, w) if w else self.ecfg.max_seq

    @torch.no_grad()
    def generate(self, prompts: np.ndarray, n_new: int = 16,
                 deadline_s: Optional[float] = None):
        """prompts (B, S). Returns ((B, n_done) greedy ids, stats), as
        the reference's `generate`: `deadline_s` is the per-request budget
        from entry; when it runs out mid-decode the remaining steps are
        shed (`stats["degraded"]`, `stats["n_shed"]`); at least the prefill
        argmax is produced.

        Raises ValueError, for a pattern with attention blocks, when
        S + n_new exceeds the attention cache (min(max_seq, attn_window)):
        the reference keeps the FIRST attn_window prefill positions of a
        longer prompt, so its decode would attend to the wrong keys
        (ROADMAP.md, queue 3). A recurrent-only pattern has no such cache."""
        t_start = time.perf_counter()
        B, S = np.asarray(prompts).shape
        if "A" in self.cfg.block_pattern and S + n_new > self._cache_len():
            raise ValueError(
                f"prompt of {S} + {n_new} new tokens exceeds the attention "
                f"cache of {self._cache_len()} positions (max_seq "
                f"{self.ecfg.max_seq}, attn_window {self.cfg.attn_window})")
        logits, cache, chunk_log = self.prefill_chunked(prompts)
        cache = self._pad_cache(cache)
        out = []
        degraded = False
        tok = torch.argmax(logits, -1)[:, None]
        for i in range(n_new):
            out.append(tok[:, 0].cpu().numpy().astype(np.int32))
            if (deadline_s is not None and i + 1 < n_new
                    and time.perf_counter() - t_start > deadline_s):
                degraded = True
                break
            logits, cache = self._decode(tok, cache, S + i)
            tok = torch.argmax(logits, -1)[:, None]
        stats = {"chunks": chunk_log, "d_final": self.d,
                 "degraded": degraded, "n_shed": n_new - len(out),
                 "deadline_s": deadline_s}
        return np.stack(out, 1), stats

    def _pad_cache(self, cache):
        """Grow the attention caches to the decode cache length (zeros past
        the prompt); the recurrent states pass through."""
        w = self._cache_len()
        out = []
        for kind, st in zip(self.cfg.block_pattern, cache):
            if kind == "A":
                grown = {}
                for name, t in st.items():
                    full = t.new_zeros((t.shape[0], w, *t.shape[2:]))
                    n = min(w, t.shape[1])
                    full[:, :n] = t[:, :n]
                    grown[name] = full
                out.append(grown)
            else:
                out.append(st)
        return out
