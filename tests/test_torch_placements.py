"""The port's placement trees against the JAX reference's PartitionSpec
trees: `models.model.param_pspecs` against `repro.models.model.
param_pspecs` for every arch at tp 1, 2, 8 and 16, leaf for leaf through
the port's name map (a port layer's leaf is its segment's stacked leaf,
whose leading None the port drops); every port parameter has exactly one
placement of its rank, and every reference leaf is covered (the
counterpart of `tests/test_arch_smoke.py`'s tree check). The same for
`cache_pspecs` on the meshes (32, 8), (16, 16) and (2, 2) at a batch the
batch ranks divide and one they do not, for `train_state_pspecs` with
`bf16_params` and `grad_compress`, and for the serving rule of the
reference's dry run (`repro/launch/dryrun.py:72-87`, read from its
source: importing that module sets XLA_FLAGS). The mesh checks raise for
a mesh a config cannot split."""
import ast
import pathlib
import textwrap
import types

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from repro.configs import ARCHS as REF_ARCHS
from repro.models import model as RM
from repro.train import train_step as RTS
from repro_torch.configs import ARCHS, get_arch
from repro_torch.models import model as M
from repro_torch.train import train_step as TS

ROOT = pathlib.Path(__file__).resolve().parents[1]
NAMES = sorted(ARCHS)


def _ref_tree(tree) -> dict:
    """A reference PartitionSpec tree as {dotted name: tuple}."""
    if isinstance(tree, P):
        return {"": tuple(tree)}
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, sub in items:
        for name, spec in _ref_tree(sub).items():
            out[f"{key}.{name}" if name else str(key)] = spec
    return out


def _ref_name(cfg, name: str) -> tuple:
    """(the reference leaf's name, whether it is stacked) of a port
    parameter name."""
    head, *rest = name.split(".", 2)
    if head == "layers":
        seg = M._layer_slots(cfg)[int(rest[0])][0] \
            if cfg.family != "encdec" else 0
        return f"segments.{seg}.{rest[1]}", True
    if head == "enc":
        return f"enc.{rest[1]}", True
    return name, False


def _hold_params(cfg, port: dict, ref_tree) -> None:
    ref = _ref_tree(ref_tree)
    covered = set()
    for name, axes in port.items():
        rname, stacked = _ref_name(cfg, name)
        assert rname in ref, name
        want = ref[rname][1:] if stacked else ref[rname]
        if stacked:
            assert ref[rname][0] is None, rname
        assert axes == want, (name, axes, want)
        covered.add(rname)
    assert covered == set(ref), sorted(set(ref) - covered)


@pytest.mark.parametrize("tp", [1, 2, 8, 16])
@pytest.mark.parametrize("name", NAMES)
def test_param_pspecs_equal_the_reference(name, tp):
    cfg = get_arch(name)
    max_seq = 2048 if cfg.family == "encdec" else 0
    port = M.param_pspecs(cfg, tp, max_seq)
    shapes = dict(M._param_shapes(cfg, max_seq))   # named_parameters()
    assert set(port) == set(shapes)
    for n, axes in port.items():
        assert len(axes) == len(shapes[n]), n
        assert all(a in (None, "data", "model") for a in axes), n
    _hold_params(cfg, port, RM.param_pspecs(REF_ARCHS[name], tp, max_seq))


MESHES = [{"data": 32, "model": 8}, {"data": 16, "model": 16},
          {"data": 2, "model": 2}]


def _as_tuples(tree):
    if isinstance(tree, P):
        return tuple(tree)
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_tuples(v) for v in tree]
    return tree


@pytest.mark.parametrize("mesh", MESHES,
                         ids=lambda m: f"{m['data']}x{m['model']}")
@pytest.mark.parametrize("name", NAMES)
def test_cache_pspecs_equal_the_reference(name, mesh):
    for batch in (mesh["data"] * 4, mesh["data"] * 4 + 1):
        ref = RM.cache_pspecs(REF_ARCHS[name], batch,
                              types.SimpleNamespace(shape=mesh))
        assert M.cache_pspecs(get_arch(name), batch, mesh) == \
            _as_tuples(ref), batch


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "qwen2-1.5b",
                                  "zamba2-1.2b", "whisper-small"])
def test_train_state_pspecs_equal_the_reference(name):
    cfg = get_arch(name)
    max_seq = 2048 if cfg.family == "encdec" else 0
    for opts in ({}, {"bf16_params": True, "grad_compress": True}):
        ref = RTS.train_state_pspecs(REF_ARCHS[name], 8, max_seq,
                                     RTS.TrainConfig(**opts))
        port = TS.train_state_pspecs(cfg, 8, max_seq, TS.TrainConfig(**opts))
        assert set(port) == set(ref)
        assert set(port["opt"]) == set(ref["opt"])
        assert port["cap_scales"] == tuple(ref["cap_scales"])
        assert port["opt"]["step"] == tuple(ref["opt"]["step"])
        trees = [(port["params"], ref["params"])]
        trees += [(port["opt"][k], ref["opt"][k]) for k in ("m", "v")]
        if opts:
            trees += [(port["opt"]["master"], ref["opt"]["master"]),
                      (port["grad_err"], ref["grad_err"])]
        for p, r in trees:
            _hold_params(cfg, p, r)
    assert TS.batch_pspec(cfg, ("pod", "data")) == {
        k: tuple(v) for k, v in RTS.batch_pspec(REF_ARCHS[name],
                                                ("pod", "data")).items()}


def _ref_serve_rule(tp):
    """The reference's `_serve_spec`, compiled from its source."""
    src = (ROOT / "src/repro/launch/dryrun.py").read_text()
    fn = next(n for n in ast.walk(ast.parse(src))
              if isinstance(n, ast.FunctionDef) and n.name == "_serve_spec")
    ns = {"P": P, "tp": tp}
    exec(textwrap.dedent(ast.get_source_segment(src, fn)), ns)
    return ns["_serve_spec"]


@pytest.mark.parametrize("tp", [8, 16])
def test_serve_rule_equals_the_reference(tp):
    rule = _ref_serve_rule(tp)
    for name in NAMES:
        cfg = get_arch(name)
        max_seq = 2048 if cfg.family == "encdec" else 0
        shapes = _ref_tree(jax.tree.map(
            lambda t: P(*t.shape), jax.eval_shape(
                lambda: RM.init_params(REF_ARCHS[name],
                                       jax.random.PRNGKey(0), max_seq))))
        ref = {n: tuple(rule(P(*spec), types.SimpleNamespace(
            shape=shapes[n], ndim=len(shapes[n]),
            size=int(np.prod(shapes[n])))))
            for n, spec in _ref_tree(RM.param_pspecs(
                REF_ARCHS[name], tp, max_seq)).items()}
        for n, axes in M.serve_pspecs(cfg, tp, max_seq).items():
            rname, stacked = _ref_name(cfg, n)
            want = ref[rname]
            if stacked:
                assert want[0] is None, rname
                want = want[1:]
            assert axes == want + (None,) * (len(axes) - len(want)), \
                (name, n, axes, want)


class _Sizes:
    tp_axis, fsdp_axis = "model", "data"

    def __init__(self, dp, tp):
        self.dp, self.tp = dp, tp

    def sizes(self):
        return {"tp": self.tp, "fsdp": self.dp}


@pytest.mark.parametrize("name, dp, tp, error, what", [
    ("qwen2-1.5b", 1, 3, ValueError, "does not split over 3 'model'"),
    ("glm4-9b", 3, 1, ValueError, "does not split over 3 'data'"),
    ("zamba2-1.2b", 3, 2, ValueError, "does not split over 3 'data'"),
    ("whisper-small", 5, 2, ValueError, "does not split over 5 'data'"),
    ("xlstm-350m", 3, 4, ValueError, "does not split over 3 'data'")])
def test_a_mesh_a_config_cannot_split_raises(name, dp, tp, error, what):
    with pytest.raises(error, match=what):
        M.check_mesh(get_arch(name), _Sizes(dp, tp))
    M.check_mesh(get_arch(name), _Sizes(1, 1))


@pytest.mark.parametrize("name, dp, tp", [
    ("zamba2-1.2b", 1, 2), ("zamba2-1.2b", 32, 8),
    ("whisper-small", 2, 2), ("whisper-small", 32, 8),
    ("xlstm-350m", 1, 4), ("xlstm-350m", 32, 8)])
def test_every_family_runs_on_a_mesh_its_placements_split(name, dp, tp):
    cfg = get_arch(name)
    M.check_mesh(cfg, _Sizes(dp, tp))
    M.check_trainable(cfg)
    # the recurrent leaves "model" splits where the reference's rule does
    places = M.param_pspecs(cfg, tp)
    split = {n for n, axes in places.items() if "model" in axes}
    if cfg.family == "hybrid":
        assert "blocks.0.mamba.in_x" in split
        assert "blocks.0.mamba.in_B" not in split
    if cfg.family == "ssm":
        assert ("blocks.0.mlstm.wq" in split) == (cfg.n_heads % tp == 0)
        assert not any(".slstm." in n for n in split)
    if cfg.family == "encdec":
        assert ("layers.0.attn.wq" in split) == (cfg.n_heads % tp == 0)
        assert "layers.0.mlp.wi" in split
