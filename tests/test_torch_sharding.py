"""The port's logical sharding rules against the JAX package's, on the CPU,
with no process: the rules need only a mesh's {axis: size} shape.

The reference's five spec cases (`tests/test_parallel.py`) on the port;
`tree_specs` of every published config's parameters, train state and W8
serving tree, and `input_specs` of every config x cell kind, equal to the
reference's at every leaf under the production mesh shapes 16x16 and
2x16x16, with the launcher's rule {"batch": ("data",)} and without, and
the recorded `fallbacks()` equal as lists. Specs are compared as tuples
(the port's `PartitionSpec` is a tuple; JAX's iterates as one). The JAX
side's input specs are built on a `jax.sharding.AbstractMesh` of the same
shape, since its `NamedSharding` wants a mesh object; its parameter specs
on the same shape-only stand-in as the port's. Also: the named runtime
flags nest as the reference's, and the MoE layout flags change no result
on plain tensors. Exact equality throughout (no arithmetic is compared
but the MoE output, which must be bitwise unchanged).
"""
import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.data import specs as jspecs
from repro.models import api as japi
from repro.models import base as jbase
from repro.models import runtime as jruntime
from repro.parallel import sharding as jshd
from repro.quantized import apply as japply
from repro.train import step as jstep
from repro_torch import configs
from repro_torch.data import specs
from repro_torch.layers import moe
from repro_torch.models import api, base, runtime
from repro_torch.parallel import data_parallel as dp
from repro_torch.parallel import sharding as shd
from repro_torch.quantized import apply
from repro_torch.train import step

MESHES = {"16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16}}
RULES = {"batch_data": {"batch": ("data",)}, "default": None}


class FakeMesh:
    """Minimal stand-in with a .shape mapping (rules only need sizes)."""

    def __init__(self, shape):
        self.shape = shape


def test_spec_basic_mapping():
    mesh = FakeMesh({"data": 16, "model": 16})
    with shd.use_mesh(mesh, {"batch": ("data",)}):
        s = shd.spec((256, 4096, 1024), ("batch", "seq", None))
        assert s == shd.PartitionSpec("data", "model") and tuple(s) == tuple(P("data", "model"))


def test_spec_divisibility_fallback():
    mesh = FakeMesh({"data": 16, "model": 16})
    with shd.use_mesh(mesh, {"batch": ("data",)}):
        # 20 heads don't divide 16 -> heads dropped, seq takes model
        s = shd.spec((32, 20, 4096, 128), ("batch", "heads", "seq", None))
        assert tuple(s) == ("data", None, "model")
        assert any(f[0] == "heads" for f in shd.fallbacks())


def test_spec_axis_used_once():
    mesh = FakeMesh({"data": 16, "model": 16})
    with shd.use_mesh(mesh):
        s = shd.spec((64, 64), ("ffn", "vocab"))   # both want model
        assert tuple(s) == ("model",)                # second dim replicated


def test_spec_multi_pod_batch():
    mesh = FakeMesh({"pod": 2, "data": 16, "model": 16})
    with shd.use_mesh(mesh):
        assert tuple(shd.spec((256, 128), ("batch", None))) == (("pod", "data"),)
        # batch 8 can't take 32-way -> the prefix ("pod",), collapsed to its name
        assert tuple(shd.spec((8, 128), ("batch", None))) == ("pod",)
        assert shd.fallbacks() == [("batch", 8, ("pod", "data"), ("pod",))]


def test_no_mesh_is_noop():
    assert shd.spec((4, 4), ("batch", None)) == () and shd.named_sharding((4,), ("batch",)) is None
    assert base.tree_sds({"w": base.ParamInfo((4,), logical=("ffn",))})["w"].sharding is None


def _port_specs(tree):
    return [(base.keystr(p), tuple(s)) for p, s in base.tree_items(base.tree_specs(tree))]


def _ref_specs(tree):
    flat = jax.tree_util.tree_flatten_with_path(jbase.tree_specs(tree),
                                                is_leaf=lambda x: isinstance(x, P))[0]
    return [(jax.tree_util.keystr(p), tuple(s)) for p, s in flat]


def _trees(arch):
    """(port, reference) abstract trees: parameters, train state, W8 tree."""
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    return [(api.abstract_params(cfg), japi.abstract_params(jcfg)),
            (step.abstract_state(cfg), jstep.abstract_state(jcfg)),
            (apply.abstract_quantized_params(cfg), japply.abstract_quantized_params(jcfg))]


@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_tree_specs_equal_the_reference(arch, mesh, rules):
    fake = FakeMesh(MESHES[mesh])
    for tree, jtree in _trees(arch):
        with shd.use_mesh(fake, RULES[rules]):
            got, got_fb = _port_specs(tree), shd.fallbacks()
        with jshd.use_mesh(fake, RULES[rules]):
            want, want_fb = _ref_specs(jtree), jshd.fallbacks()
        assert got == want
        assert got_fb == want_fb
    # the same specs ride on tree_sds's storage-free tensors
    with shd.use_mesh(fake, RULES[rules]):
        sds = base.tree_sds(tree)
        specs_ = base.tree_specs(tree)
    for (_, t), (_, s) in zip(base.tree_items(sds), base.tree_items(specs_)):
        assert t.device.type == "meta" and t.sharding.spec == s and t.sharding.mesh is fake


def _ref_inputs(cfg, shape, mesh, rules):
    with jshd.use_mesh(AbstractMesh(tuple(mesh.values()), tuple(mesh)), rules):
        d = jspecs.input_specs(cfg, shape)
        return {k: (tuple(v.shape), np.dtype(v.dtype).name, tuple(v.sharding.spec))
                for k, v in d.items()}, jshd.fallbacks()


@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_input_specs_equal_the_reference(arch, mesh, rules):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    kinds = 0
    for name, shape in base.SHAPES.items():
        if not base.supports_shape(cfg, shape):
            continue
        kinds += 1
        with shd.use_mesh(FakeMesh(MESHES[mesh]), RULES[rules]):
            d = specs.input_specs(cfg, shape)
            got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."),
                       tuple(v.sharding.spec)) for k, v in d.items()}
            got_fb = shd.fallbacks()
        want, want_fb = _ref_inputs(jcfg, jbase.SHAPES[name], MESHES[mesh], RULES[rules])
        assert list(got) == list(want) and got == want, name
        assert got_fb == want_fb, name
        assert all(v.device.type == "meta" for v in d.values())
    assert kinds == (4 if cfg.family in ("ssm", "hybrid") else 3)


def test_input_specs_without_a_mesh():
    cfg = configs.get_config("musicgen-medium")
    d = specs.input_specs(cfg, base.SHAPES["prefill_32k"])
    want = jspecs.input_specs(jconfigs.get_config("musicgen-medium"), jbase.SHAPES["prefill_32k"])
    assert {k: (tuple(v.shape), v.sharding) for k, v in d.items()} == \
        {k: (tuple(v.shape), None) for k, v in want.items()}


def test_with_flags_nesting():
    for rt in (runtime, jruntime):
        assert rt.flag("moe_impl") is None and rt.flag("moe_impl", "x") == "x"
        with rt.with_flags(moe_impl="shardmap", a=1):
            with rt.with_flags(a=2, b=3):
                assert (rt.flag("moe_impl"), rt.flag("a"), rt.flag("b")) == ("shardmap", 2, 3)
            assert (rt.flag("a"), rt.flag("b")) == (1, None)
        assert rt.flag("moe_impl") is None and rt.flag("a") is None


@pytest.mark.parametrize("flag", ["moe_token_shard", "moe_expert_aligned"])
def test_moe_layout_flags_change_no_result(flag):
    """The reference's flags change layouts only, and the port, which
    carries no activation annotations, ignores them: inside a mesh or
    not, its `moe` gives the same bits."""
    cfg = dataclasses.replace(configs.smoke("granite-moe-1b-a400m"), compute_dtype="float32")
    p = base.tree_init(moe.moe_params(cfg), torch.Generator().manual_seed(0), "cpu")
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 16, cfg.d_model))
                         .astype(np.float32))
    out, aux = moe.moe(cfg, p, x)
    for mesh in (None, FakeMesh({"data": 2, "model": 4})):
        with shd.use_mesh(mesh), runtime.with_flags(**{flag: True}):
            got, gaux = moe.moe(cfg, p, x)
        assert torch.equal(got, out)
        assert all(torch.equal(gaux[k], aux[k]) for k in aux)


def test_remat_recompute_on_another_thread_sees_the_forward_state():
    """Autograd runs a CUDA backward on its device thread, not the caller's;
    a layer that `remat_call` recomputes there sees the mesh, rules,
    fallback record, runtime flags and reduction group of its forward.
    Here the backward runs on a new thread, where none of them is set."""
    seen = []

    def fn(x):
        seen.append((shd.active_mesh(), shd.spec((8, 4), ("batch", None)),
                     runtime.flag("moe_impl"), dp.group()))
        return torch.sin(x * 2)

    mesh, group = FakeMesh({"data": 16, "model": 4}), object()
    x = torch.ones(3, requires_grad=True)
    with shd.use_mesh(mesh), runtime.with_flags(moe_impl="shardmap"), dp.reducing(group):
        y = base.remat_call("full", fn, x)
        record = shd.fallbacks
        errors = []

        def backward():
            try:
                y.sum().backward()
            except Exception as e:      # surfaced below
                errors.append(e)

        t = threading.Thread(target=backward)
        t.start()
        t.join()
        assert not errors, errors
        assert record() == [("batch", 8, ("data",), None)] * 2
    assert seen == [(mesh, shd.PartitionSpec(), "shardmap", group)] * 2
    assert torch.equal(x.grad, 2 * torch.cos(x.detach() * 2))
    assert shd.active_mesh() is None and runtime.flag("moe_impl") is None and dp.group() is None
