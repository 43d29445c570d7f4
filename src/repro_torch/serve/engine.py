"""Serving engine of the port with iCh-adaptive chunked prefill — the
counterpart of `repro.serve.engine` for the dense (qwen2, OLMo, GLM-4,
Phi-3), vlm (phi-3-vision, text only, as the reference serves it), moe
(OLMoE, DeepSeekMoE), hybrid (Zamba2) and ssm (xLSTM) families. An
encdec config (whisper) is served through `models.model.prefill` with
its frames and `decode_step`: the engine passes no frames, and the
reference's engine cannot serve it either (its prefix rerun calls
`prefill` without frames and raises KeyError; ROADMAP.md queue 3, caveat
9), so `generate` and `start_request` refuse it.

Prefill runs in chunks whose size is the iCh chunk: after each chunk the
engine classifies its measured token throughput against the running mean
band (mu +- eps*mu, paper eqs. 1-8) and adapts the divisor d as
`adapt_d` does.

* dense, vlm, moe and ssm families: incremental. Each chunk feeds only its
  own tokens through `models.model.prefill_extend` against the cache the
  last chunk left — O(chunk x context) work a chunk for dense and moe,
  O(chunk) for ssm — with chunk boundaries on multiples of a quantum Q
  (`_chunk_q`), so the last logits and the cache are a one-shot
  prefill's bits. For ssm, Q = min(cfg.ssm_chunk, S), the one-shot
  scan-block length, as in the reference. For dense and moe, Q =
  min(models.model.TOKEN_BLOCK, S) = min(256, S): the port runs a
  layer's token-wise products (a MoE layer's router and shared experts
  among them) per block of 256 tokens, because a row of a product
  changes bits with the call's row count (on an H100: every qwen2-1.5b
  product, 256 rows against 8,192; on the CPU: the vectorised exp/cos
  tails). A MoE layer's routed experts run over the whole chunk, their
  rows independent of the other tokens (`models.moe`). This quantum is
  the port's: the reference chunks attention families at any boundary
  (and on some JAX builds its own bit-identity test fails).
* hybrid family: a hybrid model's attention cache does not extend
  incrementally, so each chunk re-runs the whole prefix — quadratic in the
  prompt — and every such chunk is counted in `Engine.n_prefill_fallbacks`,
  as the reference counts it. The last chunk is a one-shot prefill of the
  whole prompt, so its logits and cache are those of one.

Two surfaces, as in the reference: `generate(prompts, ...)`, the
single-request path with the engine-level iCh band; and `start_request` /
`prefill_chunk_step` / `decode_one`, the per-request primitives the
continuous batcher (`serve/batcher.py`) drives on a `RequestState` (B = 1,
its own cache and iCh band). A dense or moe cache is written in place by
`prefill_extend` and by decode (the reference returns copies): a
`RequestState` owns its cache, and `EngineBackend.rebuild_state` builds a
fresh one.

Runs are float32 end to end, as the reference's `Engine` runs them.
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
    (`models.model.init_params`) on `device` (None = the card; raises
    without CUDA). Prefill is incremental when
    `models.model.extend_cache_specs_ok` says the config's caches extend
    (dense, vlm, moe, ssm), else a prefix rerun per chunk (hybrid). An
    encdec config is refused by `generate`, `prefill_chunked` and
    `start_request`; `_pad_cache` grows its prefill cache for
    `decode_step`."""

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

    def _extend(self, tokens: torch.Tensor, cache, done: int, q: int):
        return M.prefill_extend(self.cfg, self.params, tokens, cache, done,
                                dtype=torch.float32, ssm_chunk=q)

    def _decode(self, tok, cache, pos: int):
        return M.decode_step(self.cfg, self.params, tok, cache, pos,
                             dtype=torch.float32)

    def _refuse_encdec(self) -> None:
        if self.cfg.family == "encdec":
            raise NotImplementedError(
                f"{self.cfg.name!r} (encdec) is served through "
                f"models.model.prefill with its frames and decode_step: the "
                f"engine takes no frames, and the reference's engine cannot "
                f"serve it either (ROADMAP.md queue 3, caveat 9)")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---------------- iCh chunked prefill ----------------
    def _chunk_q(self, prompt_len: int) -> Optional[int]:
        """Chunk quantum of an incremental prefill (None for a prefix
        rerun). Ssm: the one-shot prefill's scan-block length min(
        cfg.ssm_chunk, S), so every chunk replays its scan steps. Dense
        and moe: min(TOKEN_BLOCK, S), so every block of token-wise
        products replays one-shot's (bit identity, see
        `models.model.prefill_extend`)."""
        if not self.incremental:
            return None
        q = self.cfg.ssm_chunk if self.cfg.family == "ssm" \
            else M.TOKEN_BLOCK
        return min(int(q), int(prompt_len))

    def _next_chunk(self, remaining: int, q: Optional[int] = None) -> int:
        c = max(self.ecfg.min_chunk, int(np.ceil(remaining / self.d)))
        if q:
            c = -(-c // q) * q  # round up to the chunk quantum
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
        self._refuse_encdec()
        toks = torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                               device=self.device)
        B, S = toks.shape
        log = []
        done = 0
        logits = None
        q = self._chunk_q(S)
        cache = (M.empty_extend_cache(self.cfg, B, S, dtype=torch.float32,
                                      device=self.device)
                 if self.incremental else None)
        while done < S:
            c = self._next_chunk(S - done, q)
            t0 = time.perf_counter()
            if self.incremental:
                # feed ONLY the chunk, against the last chunk's cache
                logits, cache = self._extend(toks[:, done: done + c], cache,
                                             done, q)
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

    # ---------------- per-request primitives (batcher surface) ----------
    def start_request(self, st) -> None:
        """Allocate the request's incremental prefill cache, sized to its
        exact prompt (the bit-identity requirement). Raises ValueError for
        a dense or moe request whose prompt and new tokens exceed max_seq:
        its decode would write past the cache; NotImplementedError for an
        encdec config (no frames) and a hybrid one (no extension)."""
        self._refuse_encdec()
        if not self.incremental:
            raise NotImplementedError(
                f"continuous batching needs prefill_extend; family "
                f"{self.cfg.family!r} caches don't extend incrementally")
        if self._has_kv() and st.prompt_len + st.request.n_new \
                > self._cache_len():
            raise ValueError(
                f"request {st.request.req_id}: prompt of {st.prompt_len} + "
                f"{st.request.n_new} new tokens exceeds the attention cache "
                f"of {self._cache_len()} positions")
        st.cache = M.empty_extend_cache(self.cfg, 1, st.prompt_len,
                                        dtype=torch.float32,
                                        device=self.device)

    @torch.no_grad()
    def prefill_chunk_step(self, st, chunk: int) -> None:
        """Advance one request's prefill by `chunk` tokens, rounded up to
        the chunk quantum (`_chunk_q`) and capped at the prompt's end.
        Mechanical: the caller (batcher + policy) owns timing, chunk logs
        and divisor adaptation. On completion, grows the cache to max_seq
        and emits the request's first token (the prefill argmax)."""
        if st.cache is None:
            self.start_request(st)
        done = st.prefill_done
        chunk = min(chunk, st.remaining_prefill)
        if chunk <= 0:
            return
        q = self._chunk_q(st.prompt_len)
        chunk = min(-(-chunk // q) * q, st.remaining_prefill)
        toks = torch.as_tensor(
            np.asarray(st.request.tokens)[:, done: done + chunk],
            dtype=torch.long, device=self.device)
        logits, st.cache = self._extend(toks, st.cache, done, q)
        st.prefill_done = done + chunk
        st.last_logits = logits
        if st.remaining_prefill == 0:
            st.cache = self._pad_cache(st.cache)
            st.out_tokens.append(int(torch.argmax(logits[0], -1)))

    @torch.no_grad()
    def decode_one(self, st) -> None:
        """One greedy decode token for a stream that finished prefill."""
        if not st.out_tokens:
            raise ValueError("decode_one before prefill produced a token")
        pos = st.prompt_len + len(st.out_tokens) - 1
        tok = torch.tensor([[st.out_tokens[-1]]], dtype=torch.long,
                           device=self.device)
        logits, st.cache = self._decode(tok, st.cache, pos)
        st.out_tokens.append(int(torch.argmax(logits[0], -1)))
        st.last_logits = logits

    # ---------------- decode ----------------
    def _has_kv(self) -> bool:
        """Whether the config keeps an attention KV cache."""
        return self.cfg.family in M.STACKED or "A" in self.cfg.block_pattern

    def _cache_len(self) -> int:
        """Positions of the decode KV cache: max_seq, or the attention
        window when it is shorter (hybrid; a dense or moe stack runs without
        one, as in the reference)."""
        w = 0 if self.cfg.family in M.STACKED else self.cfg.attn_window
        return min(self.ecfg.max_seq, w) if w else self.ecfg.max_seq

    @torch.no_grad()
    def generate(self, prompts: np.ndarray, n_new: int = 16,
                 deadline_s: Optional[float] = None):
        """prompts (B, S). Returns ((B, n_done) greedy ids, stats), as
        the reference's `generate`: `deadline_s` is the per-request budget
        from entry; when it runs out mid-decode the remaining steps are
        shed (`stats["degraded"]`, `stats["n_shed"]`); at least the prefill
        argmax is produced.

        Raises ValueError, for a config with an attention cache (dense, or
        a pattern with attention blocks), when S + n_new exceeds it
        (max_seq, or min(max_seq, attn_window)): the reference keeps the
        FIRST attn_window prefill positions of a longer prompt, so its
        decode would attend to the wrong keys (ROADMAP.md, queue 3), and a
        dense decode would write past max_seq. A recurrent-only pattern
        has no such cache. Raises NotImplementedError for an encdec
        config (`prefill_chunked` refuses it)."""
        t_start = time.perf_counter()
        B, S = np.asarray(prompts).shape
        if self._has_kv() and S + n_new > self._cache_len():
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
        the prompt; dense, vlm and moe: each segment's (L, B, S, Hkv, dh)
        along S; encdec: its self-attention cache so, its cross cache as
        it is); the recurrent states pass through."""
        w = self._cache_len()
        if self.cfg.family == "encdec":
            return {"self": self._pad_segments(cache["self"], w),
                    "cross": cache["cross"]}
        if self.cfg.family in M.STACKED:
            return self._pad_segments(cache, w)
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

    @staticmethod
    def _pad_segments(cache, w: int):
        """Each segment's {"k", "v"} (L, B, S, Hkv, dh) grown along S to w
        positions, zeros past S."""
        out = []
        for seg in cache:
            grown = {}
            for name, t in seg.items():
                if t.shape[2] >= w:
                    grown[name] = t
                    continue
                full = t.new_zeros((*t.shape[:2], w, *t.shape[3:]))
                full[:, :, :t.shape[2]] = t
                grown[name] = full
            out.append(grown)
        return out
