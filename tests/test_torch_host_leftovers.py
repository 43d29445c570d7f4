"""Two host pieces of the reference the port copies, held against it:
the registry's `unregister` (`repro.sched.registry`: custom entries go,
built-ins are refused) and the scalar `Welford` running mean and variance
(`repro.core.welford`: the same floats, sample for sample)."""
import numpy as np
import pytest

from repro.core import Welford as RefWelford
from repro.sched import registry as RR
from repro_torch.core import Welford, WelfordVec
from repro_torch.sched import registry as PR


@pytest.mark.parametrize("reg", [PR, RR], ids=["port", "reference"])
def test_unregister_removes_a_custom_workload(reg):
    spec = reg.register("leftover_wl", costs=lambda a: a,
                        build=lambda s, a, device=None: a)
    assert reg.get("leftover_wl") is spec
    reg.unregister("leftover_wl")
    assert "leftover_wl" not in reg.registered()
    with pytest.raises(KeyError, match="unknown workload"):
        reg.get("leftover_wl")
    reg.unregister("leftover_wl")          # an unknown name: no-op


@pytest.mark.parametrize("name", ["spmv", "bfs", "kmeans"])
def test_unregister_refuses_the_builtins_as_the_reference(name):
    for reg in (PR, RR):
        with pytest.raises(ValueError, match="cannot unregister built-in"):
            reg.unregister(name)
        assert name in reg.registered()


@pytest.mark.parametrize("name", ["moe-dispatch", "serve-prefill"])
def test_unregister_refuses_every_port_builtin(name):
    with pytest.raises(ValueError, match="cannot unregister built-in"):
        PR.unregister(name)
    assert name in PR.registered()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_welford_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    xs = rng.lognormal(0.0, 1.5, 200).tolist()
    ours, ref = Welford(), RefWelford()
    assert (ours.variance, ours.std) == (ref.variance, ref.std) == (0.0, 0.0)
    ours.update(xs[0])
    ref.update(xs[0])
    ours.update_many(xs[1:])
    ref.update_many(iter(xs[1:]))
    assert (ours.count, ours.mean, ours.m2) == (ref.count, ref.mean, ref.m2)
    assert (ours.variance, ours.std) == (ref.variance, ref.std)
    np.testing.assert_allclose(ours.std, np.std(xs), rtol=1e-12)
    # the vectorised form, one lane, folds the same floats
    vec = WelfordVec.zeros(1)
    for x in xs:
        vec.update(np.array([x]))
    assert (int(vec.count[0]), float(vec.mean[0]), float(vec.m2[0])) == \
        (ours.count, ours.mean, ours.m2)
