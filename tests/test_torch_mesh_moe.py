"""The expert-parallel MoE block of the port over a torch.distributed mesh
(gloo ranks spawned on the CPU: `tests/_mesh_ranks.py`) against the JAX
reference's per-rank composition: on each data shard of the tokens, the
reference's `moe_local(cfg, p_l, x_l, cap, n_local_experts=E/tp,
local_expert_offset=r E/tp)` with the experts of model rank r, summed
over r, the aux loss averaged over the data shards, and its `jax.grad`.
That composition is what the reference's `shard_map` block computes,
its gradient included (ROADMAP.md queue 3 caveat 14); the reference's
meshed step itself needs four host devices and a process of its own
(`tests/test_torch_mesh_train.py`). The meshes: (1, 2), (2, 1), (2, 2)
("data", "model"); the case: reduced olmoe-1b-7b with 8 experts top-2,
4 x 48 tokens, capacity scales drawn in [0.3, 2] (entries drop and are
stolen), and dropless (serving's dispatch).

Bars: y within 1e-4 of max |y|; every gradient within 1e-4 of its
largest reference value (float32 on both sides, other summation orders:
the partial outputs are summed over the model ranks); counts, dropped
and stolen exactly. Each rank holds E/tp x D/dp of wi and wg and E/tp x
F x D/dp of wo. Serving: prefill and a decode step of the reduced model
with the experts split over the mesh equal the same calls without a
mesh within 1e-5 of the logits' max (dropless: a token's expert rows do
not depend on the rest of the pool). And olmoe-1b-7b's float32 train
state at 16 layers on a (1, 4) mesh, reckoned from the port's placements
on the meta device, is under 40 GB a rank."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _mesh_ranks import start
from repro.configs import get_arch as ref_get_arch
from repro.configs import reduced as ref_reduced
from repro.models import moe as RMOE
from repro_torch.configs import get_arch
from repro_torch.models import model as M
from repro_torch.models import moe as MOE

ARCH = "olmoe-1b-7b"
OVER = dict(n_experts=8, experts_per_token=2)
B, S = 4, 48
AUX_WEIGHT = 0.37
MESHES = [(1, 2), (2, 1), (2, 2)]


@functools.lru_cache(maxsize=None)
def _inputs():
    cfg = ref_reduced(ref_get_arch(ARCH), **OVER)
    p = {k: np.asarray(v) for k, v in
         RMOE.init_moe(jax.random.PRNGKey(1), cfg).items()}
    rng = np.random.default_rng(0)
    D = cfg.d_model
    return cfg, p, {
        "x": rng.standard_normal((B, S, D)).astype(np.float32),
        "r": rng.standard_normal((B, S, D)).astype(np.float32),
        "cap": rng.uniform(0.3, 2.0, cfg.n_experts).astype(np.float32),
        "tokens": rng.integers(1, cfg.vocab_size - 1,
                               (B, 20)).astype(np.int32)}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """shape -> (the "ep" task's result, the "serve" task's): every mesh's
    ranks start at once, and the first test of a mesh waits for them."""
    tmp = tmp_path_factory.mktemp("mesh_moe")
    cfg, p, inp = _inputs()
    tasks = [("ep", dict(arch=ARCH, over=OVER, weights=p, x=inp["x"],
                         r=inp["r"], cap=inp["cap"],
                         aux_weight=AUX_WEIGHT)),
             ("serve", dict(arch=ARCH, over=OVER, tokens=inp["tokens"]))]
    runs = {shape: start(tmp, shape, tasks) for shape in MESHES}
    return functools.lru_cache(maxsize=None)(
        lambda shape: runs[shape].result())


def _reference(shape, dropless):
    """The reference's composition and its gradient (p, x)."""
    cfg, p, inp = _inputs()
    dp, tp = shape
    e_loc = cfg.n_experts // tp
    D = cfg.d_model
    cap = jnp.asarray(inp["cap"])

    def composed(p, x):
        xs = x.reshape(dp, -1, D)
        rs = jnp.asarray(inp["r"]).reshape(dp, -1, D)
        total, auxes, ys = 0.0, [], []
        counts = dropped = stolen = 0.0
        for d in range(dp):
            y = 0.0
            for m in range(tp):
                cut = slice(m * e_loc, (m + 1) * e_loc)
                pl = {"router": p["router"], "wi": p["wi"][cut],
                      "wg": p["wg"][cut], "wo": p["wo"][cut]}
                yl, al = RMOE.moe_local(cfg, pl, xs[d], cap,
                                        n_local_experts=e_loc,
                                        local_expert_offset=m * e_loc,
                                        dropless=dropless)
                y = y + yl
            ys.append(y)
            total = total + jnp.sum(y * rs[d])
            auxes.append(al["aux_loss"])
            counts = counts + al["counts"]
            dropped, stolen = dropped + al["dropped"], stolen + al["stolen"]
        total = total + AUX_WEIGHT * jnp.mean(jnp.stack(auxes))
        return total, {"y": jnp.concatenate(ys), "counts": counts,
                       "dropped": dropped / dp, "stolen": stolen / dp}

    (_, aux), (gp, gx) = jax.value_and_grad(composed, argnums=(0, 1),
                                            has_aux=True)(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(inp["x"]))
    return jax.tree.map(np.asarray, aux), jax.tree.map(np.asarray, gp), \
        np.asarray(gx)


def _close(a, b, what, tol=1e-4):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    scale = np.abs(b).max()
    assert scale > 0, what
    err = np.abs(a - b).max() / scale
    assert err <= tol, (what, err)


@pytest.mark.parametrize("dropless", [False, True],
                         ids=["capacity", "dropless"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_expert_parallel_block_matches_the_reference_composition(
        port, shape, dropless):
    cfg, _, _ = _inputs()
    got = port(shape)[0][dropless]
    aux, gp, gx = _reference(shape, dropless)
    T = B * S
    _close(got["y"].reshape(T, -1), aux["y"], "y")
    _close(got["dx"].reshape(T, -1), gx.reshape(T, -1), "dx")
    for name in ("router", "wi", "wg", "wo"):
        _close(got[name if name == "router" else f"moe.{name}"], gp[name],
               name)
    np.testing.assert_array_equal(got["counts"], aux["counts"])
    for key in ("dropped", "stolen"):
        assert float(got[key]) == float(aux[key]), key
    if dropless:
        assert float(got["dropped"]) == 0.0 == float(got["stolen"])
    else:
        assert float(got["dropped"]) > 0 and float(got["stolen"]) > 0


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_each_rank_holds_its_expert_shards(port, shape):
    cfg, _, _ = _inputs()
    dp, tp = shape
    E, D, F = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    got = port(shape)[0]
    assert (got["dp"], got["tp"]) == (dp, tp)
    assert got[False]["shapes"] == {"wi": (E // tp, D // dp, F),
                                    "wg": (E // tp, D // dp, F),
                                    "wo": (E // tp, F, D // dp)}


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_serving_on_the_mesh_matches_one_device(port, shape):
    errs = port(shape)[1]
    assert errs["prefill"] <= 1e-5 and errs["decode"] <= 1e-5, errs


def test_olmoe_state_at_full_depth_fits_a_rank_of_a_1x4_mesh():
    """float32 parameter, gradient and AdamW m and v (16 bytes a
    parameter) of olmoe-1b-7b's 16 layers, each leaf at its shape on one
    rank of a (1, 4) mesh (`models.moe.local_shape`): 16 of 64 experts a
    layer, every other leaf whole."""
    cfg = get_arch(ARCH)
    assert cfg.n_layers == 16
    model = M.init_params(cfg, 0, device="meta")
    whole = local = 0
    for name, p in model.named_parameters():
        whole += p.numel()
        local += int(np.prod(MOE.local_shape(name, p.shape,
                                             {"tp": 4, "fsdp": 1})))
    assert whole > 6.5e9
    gb = 16 * local / 1e9
    assert 30 < gb < 40, gb
