"""The port's continuous-batching surface against the reference's: the
admission queue, the load generator, the latency histograms and metrics,
the dispatch policies, the batcher on the simulated backend and clock, and
the serving journal with its crash resume, driven through the scenarios of
tests/test_serve_batch.py and tests/test_serve_resume.py on both packages
(numpy host code: journals, chunk logs, queue states and metrics must be
equal element for element); then `EngineBackend` over a reduced qwen2-1.5b
on the CPU, whose tokens must equal the reference's `EngineBackend` and
each request's tokens served alone, and `rebuild_state` /
`resume_from_journal` on the real engine, which must give the
snapshot's tokens."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs import reduced as ref_reduced
from repro.models import model as RM
from repro.robust import FaultPlan as RFaultPlan
from repro.robust import ServeJournal as RJournal
from repro.robust import resume_from_journal as ref_resume
from repro.serve import batcher as RB
from repro.serve import loadgen as RL
from repro.serve import metrics as RMet
from repro.serve import policies as RP
from repro.serve import queue as RQ
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import EngineConfig as RefEngineConfig
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import lm_params_from_reference
from repro_torch.robust import (FaultPlan, JournalDivergence, ServeJournal,
                                resume_from_journal)
from repro_torch.serve import Engine, EngineConfig
from repro_torch.serve import batcher as B
from repro_torch.serve import loadgen as LG
from repro_torch.serve import metrics as Met
from repro_torch.serve import policies as P
from repro_torch.serve import queue as Q

# both packages, module by module
PORT = dict(B=B, LG=LG, Met=Met, P=P, Q=Q, Journal=ServeJournal,
            FaultPlan=FaultPlan, resume=resume_from_journal)
REF = dict(B=RB, LG=RL, Met=RMet, P=RP, Q=RQ, Journal=RJournal,
           FaultPlan=RFaultPlan, resume=ref_resume)

# (trace, policy, queue) of each simulated scenario of the reference's
# tests: admission shedding, round robin, the iCh policy, deadline
# shedding, the kill-and-resume workload with and without stalls
SCENARIOS = {
    "shed-fcfs": (dict(rate=2000.0, prompt=("zipf", 16, 512, 1.5),
                       out=("fixed", 4, 4), seed=3, n=40),
                  ("FCFSStatic", dict(chunk=32)), dict(max_pending=4,
                                                       max_running=2), 0),
    "round-robin": (dict(rate=2000.0, prompt=("zipf", 16, 512, 1.5),
                         out=("fixed", 4, 4), seed=5, n=20),
                    ("RoundRobin", dict(chunk=32)), dict(max_running=4), 0),
    "ich-adaptive": (dict(rate=2000.0, prompt=("zipf", 16, 512, 1.5),
                          out=("fixed", 4, 4), seed=7, n=30),
                     ("IChAdaptive", {}), dict(max_running=4), 0),
    "deadline-tight": (dict(rate=500.0, prompt=("fixed", 256, 256),
                            out=("fixed", 8, 8), deadline_s=0.05, seed=11,
                            n=12),
                       ("FCFSStatic", dict(chunk=64)), dict(max_running=2),
                       0),
    "deadline-mixed": (dict(rate=500.0, prompt=("fixed", 256, 256),
                            out=("fixed", 8, 8), deadline_s=0.08, seed=11,
                            n=12),
                       ("FCFSStatic", dict(chunk=64)), dict(max_running=2),
                       0),
    "resume-workload": (dict(rate=40.0, deadline_s=2.0, seed=4, n=14),
                        ("IChAdaptive", {}), dict(max_pending=8,
                                                  max_running=4), 4),
    "resume-lognormal": (dict(rate=300.0, prompt=("lognormal", 8, 600, 1.0),
                              out=("uniform", 2, 9), seed=9, n=25),
                         ("RoundRobin", dict(chunk=24, min_chunk=8)),
                         dict(max_pending=6, max_running=3), 9),
}


def _dist(pkg, spec):
    if spec is None:
        return None
    kind, lo, hi, *rest = spec
    kw = {"alpha": rest[0]} if kind == "zipf" and rest else {}
    if kind == "lognormal" and rest:
        kw = {"sigma": rest[0]}
    return pkg["LG"].LengthDist(kind, lo, hi, **kw)


def _trace(pkg, rate, seed, n, prompt=None, out=None, deadline_s=None):
    kw = {}
    if prompt is not None:
        kw["prompt_lens"] = _dist(pkg, prompt)
    if out is not None:
        kw["output_lens"] = _dist(pkg, out)
    gen = pkg["LG"].OpenPoissonLoadGen(rate, deadline_s=deadline_s,
                                       seed=seed, **kw)
    return gen, gen.arrivals(n)


def _sim_run(pkg, name, *, journal=None, faults=None):
    trace, (policy, pkw), qkw, cost_seed = SCENARIOS[name]
    gen, arrivals = _trace(pkg, **trace)
    b = pkg["B"].ContinuousBatcher(
        getattr(pkg["P"], policy)(**pkw), queue=pkg["Q"].AdmissionQueue(
            **qkw),
        backend=pkg["B"].SimBackend(pkg["B"].StepCostModel(seed=cost_seed)),
        clock=pkg["B"].SimClock(), journal=journal, faults=faults)
    m = b.run(arrivals, make_request=pkg["B"].make_request_factory(
        gen, vocab_size=512))
    return b, m, arrivals


def _requests_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.state_dict() == y.state_dict()


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_simulated_runs_match_the_reference(name):
    """The same seeded trace through both batchers: every journal event,
    every request's state (chunk log, iCh band, tokens, timestamps), the
    shed ids and the metrics summary are equal."""
    runs = {}
    for label, pkg in (("port", PORT), ("ref", REF)):
        j = pkg["Journal"]()
        b, m, _ = _sim_run(pkg, name, journal=j)
        runs[label] = (b, m, j)
    (b, m, j), (rb, rm, rj) = runs["port"], runs["ref"]
    assert j.events == rj.events and len(j.events) > 10
    assert m.summary() == rm.summary()
    assert b.queue.state_dict() == rb.queue.state_dict()
    _requests_equal(b.queue.done, rb.queue.done)
    assert [r.req_id for r in b.queue.shed] == \
        [r.req_id for r in rb.queue.shed]
    assert b.snapshot() == rb.snapshot()


@pytest.mark.parametrize("kind", ["zipf", "lognormal", "fixed", "uniform"])
def test_loadgen_matches_the_reference(kind):
    spec = {"zipf": ("zipf", 16, 512, 1.5), "lognormal": ("lognormal", 8, 900,
                                                          0.7),
            "fixed": ("fixed", 64, 64), "uniform": ("uniform", 256, 2048)}
    for seed in (0, 3):
        _, ours = _trace(PORT, 37.5, seed, 50, prompt=spec[kind],
                         out=spec[kind], deadline_s=0.5)
        _, theirs = _trace(REF, 37.5, seed, 50, prompt=spec[kind],
                           out=spec[kind], deadline_s=0.5)
        assert [dataclasses.asdict(a) for a in ours] == \
            [dataclasses.asdict(a) for a in theirs]


def test_histograms_and_metrics_match_the_reference():
    rng = np.random.default_rng(7)
    xs = np.clip(np.concatenate([rng.lognormal(-3.0, 1.0, 3000),
                                 rng.uniform(1e-4, 2.0, 2000)]), 1e-6, None)
    h, rh = Met.LatencyHistogram(resolution=0.02), \
        RMet.LatencyHistogram(resolution=0.02)
    h.record_many(xs)
    rh.record_many(xs)
    assert h.state_dict() == rh.state_dict()
    for q in (0, 10, 50, 90, 99, 99.9, 100):
        assert h.percentile(q) == rh.percentile(q)
    other, rother = Met.LatencyHistogram(resolution=0.02), \
        RMet.LatencyHistogram(resolution=0.02)
    other.record_many(xs[::3] * 10)
    rother.record_many(xs[::3] * 10)
    h.merge(other)
    rh.merge(rother)
    assert h.state_dict() == rh.state_dict()
    with pytest.raises(ValueError):
        h.merge(Met.LatencyHistogram(resolution=0.05))
    with pytest.raises(ValueError):
        h.record(float("nan"))
    back = Met.LatencyHistogram.from_state(rh.state_dict())
    assert back.percentile(99) == rh.percentile(99)


@pytest.mark.parametrize("policy", ["FCFSStatic", "RoundRobin",
                                    "IChAdaptive"])
def test_policies_choose_as_the_reference(policy):
    """The same queue state, then the same observed steps: the same plans
    (prefill target, chunk, decode streams) and the same per-request
    bands."""
    plans = {}
    for label, pkg in (("port", PORT), ("ref", REF)):
        q = pkg["Q"].AdmissionQueue(max_running=4)
        for i, n in enumerate((1024, 48, 300, 77)):
            q.submit(pkg["Q"].Request(req_id=i, tokens=np.zeros((1, n)),
                                      n_new=2))
        q.admit(0.0)
        pol = getattr(pkg["P"], policy)()
        out = []
        for step, dt in enumerate([1.0, 1.0, 1.2, 0.5, 9.0, 1.0, 1.1]):
            plan = pol.choose(q, now=float(step))
            if plan.prefill is None:
                break
            out.append((plan.prefill.request.req_id, plan.prefill_chunk,
                        [st.request.req_id for st in plan.decode]))
            plan.prefill.prefill_done += min(plan.prefill_chunk,
                                             plan.prefill.remaining_prefill)
            pol.observe(plan, dt)
        out.append([(st.d, list(st.ks)) for st in q.running])
        plans[label] = out
    assert plans["port"] == plans["ref"]
    assert [p.name for p in P.default_policies()] == \
        [p.name for p in RP.default_policies()]


def _run_killed(pkg, kill_events, faults):
    """A journaled run of the resume workload abandoned at the first step
    boundary where its journal holds `kill_events` events (the crash),
    as tests/test_serve_resume.py drives it."""
    trace, (policy, pkw), qkw, cost_seed = SCENARIOS["resume-workload"]
    gen, arrivals = _trace(pkg, **trace)
    mk = pkg["B"].make_request_factory(gen, vocab_size=512)
    j = pkg["Journal"]()
    b = pkg["B"].ContinuousBatcher(
        getattr(pkg["P"], policy)(**pkw), queue=pkg["Q"].AdmissionQueue(
            **qkw),
        backend=pkg["B"].SimBackend(pkg["B"].StepCostModel(seed=cost_seed)),
        clock=pkg["B"].SimClock(), journal=j, faults=faults)
    pending = sorted(arrivals, key=lambda a: (a.t, a.req_id))
    i = 0
    b._t_start = b.clock.now()
    b._j({"ev": "run", "t_start": b._t_start})
    while len(j.events) < kill_events:
        now = b.clock.now()
        while i < len(pending) and pending[i].t + b._t_start <= now:
            b.submit(mk(dataclasses.replace(pending[i],
                                            t=pending[i].t + b._t_start)))
            i += 1
        if not b.step():
            if i >= len(pending):
                break
            gap = pending[i].t + b._t_start - now
            b._j({"ev": "gap", "dt": gap})
            b.clock.advance(gap)
    return j


@pytest.mark.parametrize("seed", [0, 3, 7])
def test_kill_and_resume_matches_the_reference(seed):
    """The kill-and-resume scenario of tests/test_serve_resume.py on both
    packages, with a fault plan's stalls: where the reference's resumed
    run equals its uninterrupted run, the port's does too, with the same
    journal and metrics; where the reference refuses to resume (seed 7:
    killed just after a step that consumed a stall, the replay comes up
    short; ROADMAP.md queue 3), the port refuses with the same message."""
    out = {}
    for label, pkg in (("port", PORT), ("ref", REF)):
        plan = pkg["FaultPlan"](seed=seed, stalls=((0, 3, 1.5), (0, 9, 0.7)))
        j_full = pkg["Journal"]()
        b_full, m_full, arrivals = _sim_run(pkg, "resume-workload",
                                            journal=j_full, faults=plan)
        kill = 2 + (seed * 37) % (len(j_full.events) - 4)
        j_loaded = pkg["Journal"].from_jsonl(_run_killed(
            pkg, kill, plan).to_jsonl())
        trace, (policy, pkw), qkw, cost_seed = SCENARIOS["resume-workload"]
        try:
            rb = pkg["resume"](
                j_loaded, policy=getattr(pkg["P"], policy)(**pkw),
                queue=pkg["Q"].AdmissionQueue(**qkw),
                backend=pkg["B"].SimBackend(pkg["B"].StepCostModel(
                    seed=cost_seed)), faults=plan)
        except RuntimeError as e:   # JournalDivergence of either package
            out[label] = (type(e).__name__, str(e))
            continue
        gen, _ = _trace(pkg, **trace)
        m_res = rb.run(arrivals, make_request=pkg["B"].make_request_factory(
            gen, vocab_size=512))
        assert rb.journal.events == j_full.events
        assert m_res.summary() == m_full.summary()
        assert rb.queue.state_dict() == b_full.queue.state_dict()
        out[label] = (rb.journal.events, m_res.summary())
    assert out["port"] == out["ref"]
    assert (out["ref"][0] == "JournalDivergence") == (seed == 7)


def test_journal_mechanics_and_refusals():
    j = ServeJournal()
    _sim_run(PORT, "resume-workload", journal=j)
    back = ServeJournal.from_jsonl(j.to_jsonl())
    assert back.events == j.events and back.header == j.header
    torn = ('{"ev":"header","version":1}\n{"ev":"run","t_start":0.0}\n'
            '{"ev":"step","i":0,"dt":0.0')
    assert [e["ev"] for e in ServeJournal.from_jsonl(torn).events] == \
        ["header", "run"]
    j2 = ServeJournal()
    j2.append({"ev": "x", "v": np.int64(3), "f": np.float64(0.5)})
    assert j2.events[0] == {"ev": "x", "v": 3, "f": 0.5}
    queue = Q.AdmissionQueue(max_pending=8, max_running=4)
    with pytest.raises(JournalDivergence, match="policy"):
        resume_from_journal(j, policy=P.FCFSStatic(), queue=queue,
                            backend=B.SimBackend(B.StepCostModel(seed=4)))
    with pytest.raises(JournalDivergence, match="cost_model"):
        resume_from_journal(j, policy=P.IChAdaptive(), queue=queue,
                            backend=B.SimBackend(B.StepCostModel(seed=99)))
    with pytest.raises(JournalDivergence, match="no header"):
        resume_from_journal(ServeJournal(), policy=P.IChAdaptive())


# ------------------------------------------------ the real engine, reduced

@pytest.fixture(scope="module")
def qwen2():
    """Reduced qwen2-1.5b (dh 16) with random qkv biases: the reference's
    parameters (jnp) and the port's model holding the same weights."""
    ref_cfg = ref_reduced(ref_get_arch("qwen2-1.5b"))
    cfg = reduced(get_arch("qwen2-1.5b"))
    tree = jax.tree.map(np.asarray, RM.init_params(ref_cfg,
                                                   jax.random.PRNGKey(0)))
    attn = tree["segments"][0]["attn"]
    rng = np.random.default_rng(11)
    for name in ("bq", "bk", "bv"):
        attn[name] = (rng.standard_normal(attn[name].shape) * 0.5).astype(
            np.float32)
    model = lm_params_from_reference(cfg, tree, device="cpu")
    return ref_cfg, cfg, jax.tree.map(jnp.asarray, tree), model


ECFG = dict(max_seq=640, min_chunk=4)
# round-robin chunks of the port's chunk quantum (TOKEN_BLOCK = 256), so
# that both packages chunk the prompts (longer than 256 tokens) alike
CHUNK = dict(chunk=256, min_chunk=4)


def _engine_batcher(pkg, engine, journal=None, clock=True):
    return pkg["B"].ContinuousBatcher(
        pkg["P"].RoundRobin(**CHUNK),
        queue=pkg["Q"].AdmissionQueue(max_running=4),
        backend=pkg["B"].EngineBackend(engine),
        clock=pkg["B"].SimClock() if clock else None, journal=journal)


def _prompts(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (1, s), dtype=np.int64)
            for s in lens]


def test_engine_backend_tokens_match_the_reference_and_serial(qwen2):
    """Three requests interleaved through each package's batcher on its
    real engine: the port's tokens equal the reference's, and each equals
    the request served alone through the port's `Engine.generate`; the
    chunk logs are equal too."""
    ref_cfg, cfg, ref_params, model = qwen2
    toks = _prompts(cfg, (600, 300, 420), seed=1)
    eng = Engine(cfg, model, EngineConfig(**ECFG), device="cpu")
    b = _engine_batcher(PORT, eng)
    sts = [b.submit(Q.Request(req_id=i, tokens=t, n_new=6, t_arrival=0.0))
           for i, t in enumerate(toks)]
    while b.step():
        pass
    rb = _engine_batcher(REF, RefEngine(ref_cfg, ref_params,
                                        RefEngineConfig(**ECFG)))
    rsts = [rb.submit(RQ.Request(req_id=i, tokens=t, n_new=6,
                                 t_arrival=0.0)) for i, t in enumerate(toks)]
    while rb.step():
        pass
    assert [st.out_tokens for st in sts] == [st.out_tokens for st in rsts]
    assert [[c["chunk"] for c in st.chunk_log] for st in sts] == \
        [[c["chunk"] for c in st.chunk_log] for st in rsts]
    assert all(len(st.chunk_log) > 1 for st in sts)
    alone = Engine(cfg, model, EngineConfig(**ECFG), device="cpu")
    for st, t in zip(sts, toks):
        ids, _ = alone.generate(t, n_new=6)
        assert st.out_tokens == ids[0].tolist()
    assert eng.n_prefill_fallbacks == 0
    assert b.metrics.n_prefill_fallback == 0


def test_engine_backend_chunks_round_up_to_the_quantum(qwen2):
    """A chunk rounds up to the quantum (TOKEN_BLOCK = 256) and stops at the
    prompt's end: chunks of 5 become 256 and then the last 44 tokens, a
    prompt under 256 tokens is one chunk, and a chunk of the whole prompt
    is one. The tokens do not depend on the chunks."""
    _, cfg, _, model = qwen2
    toks, short = _prompts(cfg, (300, 21), seed=3)
    eng = Engine(cfg, model, EngineConfig(**ECFG), device="cpu")
    outs = []
    for prompt, chunk, expect in ((toks, 5, [256, 44]),
                                  (toks, 300, [300]), (short, 5, [21])):
        st = Q.RequestState(request=Q.Request(req_id=0, tokens=prompt,
                                              n_new=3))
        sizes = []
        while st.remaining_prefill:
            before = st.prefill_done
            eng.prefill_chunk_step(st, chunk)
            sizes.append(st.prefill_done - before)
        assert sizes == expect
        while len(st.out_tokens) < 3:
            eng.decode_one(st)
        outs.append(st.out_tokens)
    assert outs[0] == outs[1]
    assert len(outs[2]) == 3
    with pytest.raises(ValueError, match="decode_one before prefill"):
        eng.decode_one(Q.RequestState(request=Q.Request(
            req_id=1, tokens=toks, n_new=3)))
    with pytest.raises(ValueError, match="exceeds the attention cache"):
        eng.start_request(Q.RequestState(request=Q.Request(
            req_id=2, tokens=toks, n_new=400)))


def test_rebuild_state_and_resume_give_the_snapshot_tokens(qwen2):
    """Mid-decode, a snapshot restored onto a fresh engine rebuilds each
    request's KV cache from its chunk log (`rebuild_state`) and finishes
    with the uninterrupted run's tokens; a wall-clock journal of the same
    run resumes (`resume_from_journal`) to the same streams."""
    _, cfg, _, model = qwen2
    toks = _prompts(cfg, (300, 270), seed=7)

    def engine():
        return Engine(cfg, model, EngineConfig(**ECFG), device="cpu")

    b_full = _engine_batcher(PORT, engine())
    for i, t in enumerate(toks):
        b_full.submit(Q.Request(req_id=i, tokens=t, n_new=6, t_arrival=0.0))
    while b_full.step():
        pass
    full = [st.out_tokens for st in b_full.queue.done]

    b = _engine_batcher(PORT, engine())
    sts = [b.submit(Q.Request(req_id=i, tokens=t, n_new=6, t_arrival=0.0))
           for i, t in enumerate(toks)]
    for _ in range(7):
        b.step()
    assert any(st.out_tokens for st in sts)
    snap = json.loads(json.dumps(b.snapshot()))
    rb = B.ContinuousBatcher.restore(
        snap, policy=P.RoundRobin(**CHUNK),
        backend=B.EngineBackend(engine()))
    for st in rb.queue.running:
        assert st.cache is not None
    while rb.step():
        pass
    assert [st.out_tokens for st in rb.queue.done] == full

    j = ServeJournal()
    jb = _engine_batcher(PORT, engine(), journal=j, clock=False)
    jsts = [jb.submit(Q.Request(req_id=i, tokens=t, n_new=6, t_arrival=0.0))
            for i, t in enumerate(toks)]
    jb._t_start = jb.clock.now()
    for _ in range(6):
        jb.step()
    res = resume_from_journal(j, policy=P.RoundRobin(**CHUNK),
                              queue=Q.AdmissionQueue(max_running=4),
                              backend=B.EngineBackend(engine()))
    for orig, st in zip(jsts, res.queue.running + res.queue.done):
        assert st.out_tokens == orig.out_tokens
        assert st.prefill_done == orig.prefill_done
    while res.step():
        pass
    assert sorted((st.request.req_id, st.out_tokens)
                  for st in res.queue.done) == list(enumerate(full))
