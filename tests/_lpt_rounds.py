"""Numpy mirror of the round rule of `lpt_assign` (csrc/lpt.cu), shared by
the CPU tests of the schedule pipeline and the card tests of the kernel.

heapq's LPT loop takes one chain at a time: pop the worker of least
(load, id), add the chain's cost, push it back. The kernel places chains
in rounds instead. With the workers sorted by (load, id) as pi_0 < pi_1 <
..., and the next m <= p chains costing c_0, c_1, ..., chain t goes to
pi_t exactly when every earlier chain's updated key (load(pi_j) + c_j,
pi_j), j < t, is above pi_t's own key: pi_t is then the least of the
untouched workers and below every updated one, which is heapq's choice.
A round places the chains up to the first t where that fails, then merges
the updated keys back among the untouched ones. A round whose first chain
leaves the least load unchanged (load + c == load, e.g. a zero cost)
leaves the heap as it was, so it places the whole run of such chains on
pi_0 instead. The mirror follows the kernel round for round, so its round
count is the count the kernel reports."""
import heapq

import numpy as np

from repro_torch.kernels.lpt.lpt import ROUND_WINDOW  # chains a round, at most


def heapq_lpt(cost, order, n_real, p):
    """heapq's (load, worker) LPT loop over the ids of `order` below
    n_real; the others keep -1."""
    heap = [(0.0, w) for w in range(p)]
    out = np.full(order.size, -1, np.int32)
    for c in order:
        if 0 <= c < n_real:
            load, w = heapq.heappop(heap)
            out[c] = w
            heapq.heappush(heap, (load + float(cost[c]), w))
    return out


def round_lpt(cost, order, n_real, p):
    """(worker of every chain, rounds): `lpt_assign` by its round rule."""
    real = order[(order >= 0) & (order < n_real)]
    load, wid = np.zeros(p), np.arange(p)     # sorted by (load, id)
    out = np.full(order.size, -1, np.int32)
    i = rounds = 0
    while i < real.size:
        m = min(p, ROUND_WINDOW, real.size - i)
        chains = real[i:i + m]
        c = cost[chains]
        rounds += 1
        same = load[0] + c == load[0]
        if same[0]:
            k = m if same.all() else int(np.argmin(same))
            out[chains[:k]] = wid[0]
        else:
            new = load[:m] + c
            k, least = m, (new[0], wid[0])
            for t in range(1, m):
                if least < (load[t], wid[t]):
                    k = t
                    break
                least = min(least, (new[t], wid[t]))
            out[chains[:k]] = wid[:k]
            keys = sorted(zip(np.concatenate([new[:k], load[k:]]), wid))
            load = np.array([a for a, _ in keys])
            wid = np.array([w for _, w in keys])
        i += k
    return out, rounds
