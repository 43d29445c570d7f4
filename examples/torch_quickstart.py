"""Quickstart on the PyTorch port: the unified `repro_torch.sched`
scheduler API.

One facade, four backends. A `LoopScheduler` turns a per-item cost array
into a `Schedule` that (a) replays through the discrete-event simulator,
(b) drives the real threaded executor, and (c) lowers to the tile layout
the hand-written CUDA kernels consume — and its workload registry builds
the kernels themselves. Repeated requests hit the LRU schedule cache.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The kernels run on the card by default; `--device cpu` runs their plain
PyTorch versions. The simulator, schedule, feedback and serving lines
are numpy and print the same text as `examples/quickstart.py`; the two
kernel lines name the device instead of the reference's interpret mode.
"""
import argparse

import numpy as np

from repro_torch import sched
from repro_torch.core import workloads as WL


def policy_table(scheduler: sched.LoopScheduler, costs: np.ndarray, p: int):
    """The paper's Table-2 sweep through the facade's simulator backend."""
    t1 = scheduler.simulate(costs, policy=sched.guided(1), p=1).makespan
    print(f"workload: synth Exp-Decreasing, n={len(costs)}, p={p}")
    print(f"{'policy':16s} {'speedup':>8s} {'steals':>7s} {'chunks':>7s}")
    best = {}
    for pol in sched.paper_policy_grid(p):
        r = scheduler.simulate(costs, policy=pol, p=p)
        sp = t1 / r.makespan
        best[pol.name] = max(best.get(pol.name, 0.0), sp)
        print(f"{pol.label():16s} {sp:8.2f} {r.steals:7d} {r.chunks:7d}")
    print("best per method:", {k: round(v, 2) for k, v in best.items()})
    r = scheduler.simulate(costs, policy=sched.ich(), p=p)
    print("iCh final d_i (chunk divisors):", np.round(r.ds, 2))
    print("iCh k_i (per-worker progress estimates):", np.round(r.ks, 1))


def one_schedule_three_backends(scheduler: sched.LoopScheduler):
    """The same Schedule object across simulator, executor, and lowering."""
    rng = np.random.default_rng(0)
    sizes = np.minimum(rng.zipf(1.8, 2000), 500).astype(np.int64)
    s = scheduler.schedule(sizes)                       # construct (cached)
    print(f"\nschedule: {s.n_items} items -> {s.n_tiles} tiles of "
          f"{s.rows_per_tile} x W={s.width}")

    # (a) simulator: replay the constructed tiles chunk-for-chunk
    rep = s.replay()
    sim_work = np.array([w for (_, _, _, w) in rep.chunk_log])
    assert np.abs(sim_work - s.tile_cost()).max() < 1e-6
    print(f"simulator replay: {rep.chunks} chunks == {s.n_tiles} tiles, "
          f"per-tile work matches prediction")

    # (b) threaded executor: every work unit exactly once, same tile chunks
    import threading
    hits = np.zeros(int(sizes.sum()), np.int64)
    lock = threading.Lock()

    def body(u):
        with lock:
            hits[u] += 1

    st = s.parallel_for_units(body, p=4)
    assert (hits == 1).all() and st.chunks == s.n_tiles
    print(f"executor: {st.chunks} chunks on 4 threads, "
          "every unit executed exactly once")

    # (c) lowering: the tile layout the CUDA kernels consume
    tiles = s.lower()
    print(f"lowered TileSchedule: item_id {tiles.item_id.shape}, "
          f"width {tiles.width}")

    # LRU cache: an identical request skips construction entirely
    again = scheduler.schedule(sizes)
    assert again is s
    print(f"schedule cache: {scheduler.cache_stats}")


def registry_kernels(scheduler: sched.LoopScheduler):
    """Registered workloads: kernels built from raw inputs, no ops classes."""
    print("\nregistered workloads:", sched.registered())
    rng = np.random.default_rng(1)
    n = 256
    row_nnz = np.minimum(rng.zipf(1.8, n), 60).astype(np.int64)
    indptr = np.concatenate([[0], np.cumsum(row_nnz)])
    indices = rng.integers(0, n, int(indptr[-1])).astype(np.int32)
    data = rng.standard_normal(int(indptr[-1])).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)

    from repro_torch.kernels.ich_spmv.ref import spmv_ref
    dev = scheduler.device.type
    spmv = scheduler.build("spmv", indptr, indices, data)
    y = spmv(x).cpu().numpy()
    np.testing.assert_allclose(
        y, spmv_ref(indptr, indices, data, x).cpu().numpy(), atol=1e-4,
        rtol=1e-4)
    print(f"spmv kernel ({dev}): y[:4] = {np.round(y[:4], 3)} "
          f"(matches reference)")

    bfs = scheduler.build("bfs", indptr, indices)
    levels = bfs.levels(0).cpu().numpy()
    print(f"bfs kernel ({dev}): reached "
          f"{int((levels >= 0).sum())}/{n} vertices from source 0")


def measured_cost_feedback(scheduler: sched.LoopScheduler):
    """Close the loop (DESIGN.md §2.7): observe measured costs, refine,
    re-lower, and watch the sharded makespan on the TRUE costs drop."""
    from repro_torch.core.simulator import SimParams

    rng = np.random.default_rng(7)
    n = 4000
    sizes = np.minimum(rng.zipf(1.8, n), 800).astype(np.int64)
    indptr = np.concatenate([[0], np.cumsum(sizes)])
    # the a-priori estimate (cost ~ nnz) misses a hidden per-item jitter
    true = (1.0 + sizes) * rng.uniform(0.3, 3.0, n)
    zero = SimParams(dispatch_overhead=0.0, local_dispatch_overhead=0.0,
                     speed_jitter=0.0)
    s = scheduler.schedule(sched.NnzCosts(indptr), p=8)
    print("\nmeasured-cost feedback (sharded makespan on true costs):")
    for r in range(3):
        rep = s.replay_refined(true, sharded=True, params=zero,
                               record_chunks=True)
        print(f"  generation {s.generation}: makespan {rep.makespan:,.0f} "
              f"(perfect balance {rep.busy / 8:,.0f})")
        tile_true = np.array([wk for (*_, wk) in rep.chunk_log])
        s_next = s.observe(tile_true, level="tile").refine()
        assert s_next.replay_refined(true, sharded=True,
                                     params=zero).makespan \
            <= rep.makespan + 1e-9
        s = s_next


def serving():
    """Continuous-batching serving (DESIGN.md §2.10): submit requests on
    an open Poisson clock, serve them with the ich-adaptive dispatch
    policy on the simulated backend, and read the tail latencies plus
    each request's adapted chunk divisor."""
    from repro_torch import serve

    gen = serve.OpenPoissonLoadGen(
        rate=20.0,
        prompt_lens=serve.LengthDist("zipf", 64, 2048, alpha=1.1),
        output_lens=serve.LengthDist("fixed", 8, 8), seed=3)
    b = serve.ContinuousBatcher(serve.IChAdaptive(),
                                queue=serve.AdmissionQueue(max_running=4))
    m = b.run(gen.arrivals(4),
              make_request=serve.make_request_factory(gen, vocab_size=512))
    assert m.n_completed == 4 and m.n_degraded == 0
    print("\nserving (4 requests, open Poisson clock, ich-adaptive):")
    print(f"  TTFT p50 {m.ttft.percentile(50) * 1e3:.1f} ms, "
          f"p99 {m.ttft.percentile(99) * 1e3:.1f} ms; "
          f"e2e p99 {m.e2e.percentile(99) * 1e3:.1f} ms; "
          f"goodput {m.goodput():.0f} tok/s")
    for st in sorted(b.queue.done, key=lambda s: s.request.req_id):
        print(f"  req {st.request.req_id}: prompt {st.prompt_len:4d} tok "
              f"in {len(st.chunk_log)} chunks, adapted d={st.d:g} "
              f"(d_0=4), ttft {st.stats()['ttft'] * 1e3:.1f} ms")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    scheduler = sched.LoopScheduler(p=28, device=args.device)
    costs = WL.synth_exp(30_000, increasing=False)
    policy_table(scheduler, costs, p=28)
    one_schedule_three_backends(scheduler)
    registry_kernels(scheduler)
    measured_cost_feedback(scheduler)
    serving()
    print("\nOK")


if __name__ == "__main__":
    main()
