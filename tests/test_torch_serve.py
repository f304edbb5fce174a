"""The port's slice end to end on the CPU, against the JAX package.

`Session(device="cpu")` compiles through frontend -> pipeline -> target
and the `cuda` target's wrappers run the kernels' plain versions, so the
whole served path (register, predict, stacked predict_many rounds, the
megakernel preference and its chain fallback) is held against JAX's
`pallas` target in interpret mode and `predict_quantized`, exactly.
Also the package boundary: the port imports without JAX or `repro`, and
never quietly leaves the card.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro import netgen as jnetgen
from repro.core import quantize as jquantize
from repro_torch import netgen
from repro_torch.core import quantize
from repro_torch.kernels.binary_matvec import ops

from _netgen_helpers import images, random_net

ROOT = Path(__file__).resolve().parent.parent


def _ref(net, x):
    return np.asarray(jquantize.predict_quantized(net)(jnp.asarray(x)))


def _port(net):
    return quantize.from_numpy(net.weights, net.input_threshold)


def _pruned_versions():
    """Three 2-layer versions whose hidden widths prune to different
    sizes (dead columns of w1), so stacking pads them."""
    nets = {}
    for i, dead in enumerate((0, 5, 11)):
        net = random_net(60 + i, (40, 24, 6), lo=-5, hi=5)
        ws = [w.copy() for w in net.weights]
        ws[0][:, :dead] = 0
        nets[f"v{i}"] = jquantize.QuantizedNet(weights=ws)
    return nets


@pytest.mark.parametrize("target", ["cuda[fusednet=true]", "cuda[planes=true]",
                                    "torch"])
def test_session_compile_matches_pallas_and_reference(target):
    jnet = random_net(50, (45, 21, 7), lo=-5, hi=5)
    x = images(50, 19, 45)
    jart = jnetgen.Session().compile(jnet, target="pallas[fusednet=true]")
    art = netgen.Session(device="cpu").compile(_port(jnet), target=target)
    got = art(x)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jart(jnp.asarray(x))))
    np.testing.assert_array_equal(got.numpy(), _ref(jnet, x))
    assert art.digest == jart.digest and art.pipeline == jart.pipeline
    if target != "torch":
        jdp = jnetgen.Session().compile(
            jnet, target=target.replace("cuda", "pallas")).artifact
        assert (art.artifact.datapath, art.artifact.launches_per_call,
                art.plan_form) == (jdp.datapath, jdp.launches_per_call, "planes")


def test_session_memory_tier_and_errors():
    session = netgen.Session(device="cpu", capacity=1)
    net, other = _port(random_net(1, (12, 4))), _port(random_net(2, (12, 4)))
    a = session.compile(net, target="cuda[planes=true]")
    assert session.compile(net, target="cuda", planes=True) is a
    session.compile(other, target="cuda[planes=true]")
    session.compile(net, target="cuda[planes=true]")
    s = session.stats()
    assert (s.hits, s.compiles, s.evictions) == (1, 3, 2)
    assert session.compile(net, target="cuda").plan_form == "dense"
    with pytest.raises(ValueError):            # packed excludes the bit-planes
        session.compile(net, target="cuda[packed=true,planes=true]")
    with pytest.raises(TypeError):
        a(np.zeros((2, 12), np.float32))
    with pytest.raises(ValueError):
        a(np.zeros((2, 11), np.uint8))
    assert a(torch.zeros((2, 12), dtype=torch.uint8)).shape == (2,)


# The port's targets beside the JAX package's, for the dense and packed
# chains and the 2-layer single-launch kernel.
NEW_TARGETS = [("cuda", "pallas"), ("cuda[packed=true]", "pallas[packed=true]"),
               ("fused", "fused")]


@pytest.mark.parametrize("target,jtarget", NEW_TARGETS)
def test_session_dense_packed_fused_match_pallas(target, jtarget):
    jnet = random_net(51, (45, 21, 7), lo=-5, hi=5)
    x = images(51, 19, 45)
    jart = jnetgen.Session().compile(jnet, target=jtarget)
    art = netgen.Session(device="cpu").compile(_port(jnet), target=target)
    got = art(x)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jart(jnp.asarray(x))))
    np.testing.assert_array_equal(got.numpy(), _ref(jnet, x))
    assert (art.artifact.datapath, art.artifact.launches_per_call, art.plan_form) == \
        (jart.artifact.datapath, jart.artifact.launches_per_call, jart.plan_form)


def test_fused_refuses_other_depths_and_packed_refuses_planes():
    deep = random_net(52, (30, 12, 9, 4), lo=-5, hi=5)
    with pytest.raises(netgen.IrregularCircuitError):
        netgen.Session(device="cpu").compile(_port(deep), target="fused")
    with pytest.raises(jnetgen.IrregularCircuitError):
        jnetgen.Session().compile(deep, target="fused")
    # a 3-layer net runs through the chains, as in JAX
    x = images(52, 7, 30)
    got = netgen.Session(device="cpu").compile(_port(deep), target="cuda")(x)
    np.testing.assert_array_equal(got.numpy(), _ref(deep, x))
    for opts in ("packed=true,planes=true", "packed=true,fusednet=true"):
        with pytest.raises(ValueError):
            netgen.Session(device="cpu").compile(_port(deep), target=f"cuda[{opts}]")
        with pytest.raises(ValueError):
            jnetgen.Session().compile(deep, target=f"pallas[{opts}]")


@pytest.mark.parametrize("target,jtarget", NEW_TARGETS)
def test_netserver_dense_packed_fused_match_jax_server(target, jtarget):
    """cuda and cuda[packed=true] stack the versions (the per-model chain
    looped over the model axis); fused has no multi-net form, so both
    servers fall back to one dispatch per version."""
    jnets = _pruned_versions()
    jserver = jnetgen.NetServer(target=jtarget, slot_capacity=8)
    server = netgen.NetServer(session=netgen.Session(device="cpu"),
                              target=target, slot_capacity=8)
    for name, jnet in jnets.items():
        jserver.register(name, jnet)
        server.register(name, _port(jnet))
    x = images(62, 20, 40)
    single = server.predict("v2", x)
    np.testing.assert_array_equal(single, jserver.predict("v2", x))
    for req in ({"v0": x, "v1": x[:5], "v2": x[:13]},
                {"v0": x[:8], "v1": x[8:16], "v2": x[:3]}):
        got, want = server.predict_many(req), jserver.predict_many(req)
        for v in req:
            np.testing.assert_array_equal(got[v], want[v], err_msg=v)
            np.testing.assert_array_equal(got[v], _ref(jnets[v], req[v]))
    counts, jcounts = server.dispatch_counts, jserver.dispatch_counts
    assert counts == {k: jcounts[k] for k in counts}
    stacked = target != "fused"
    assert counts == {"single": 1, "stacked": 2 * stacked, "sharded": 0,
                      "fallback": 2 * (not stacked)}
    names = tuple(sorted(jnets))
    fn, (jfn, _) = server._stacked_fn(names), jserver._stacked_fn(names)
    if stacked:
        assert (fn.datapath, fn.launches_per_call, fn.plan_form) == \
            (jfn.datapath, jfn.launches_per_call, jfn.plan_form)
        assert fn.launches_per_call == 2 * 3
    else:
        assert fn is None and jfn is None


def test_netserver_matches_jax_server():
    jnets = _pruned_versions()
    jserver = jnetgen.NetServer(target="pallas[planes=true]", slot_capacity=8)
    server = netgen.NetServer(session=netgen.Session(device="cpu"),
                              target="cuda[planes=true]", slot_capacity=8)
    for name, jnet in jnets.items():
        jserver.register(name, jnet)
        server.register(name, _port(jnet))
    widths = {server.compiled_for(v).plan().layers[0].fan_out for v in jnets}
    assert len(widths) == 3, widths               # pruning differs per version

    x = images(61, 20, 40)
    reqs = [{"v0": x, "v1": x[:5], "v2": x[:13]},       # skewed: 3, 2, 1 active
            {"v0": x[:8], "v1": x[8:16], "v2": x[:3]}]
    single = server.predict("v1", x)
    np.testing.assert_array_equal(single, jserver.predict("v1", x))
    for req in reqs:
        got, want = server.predict_many(req), jserver.predict_many(req)
        for v in req:
            np.testing.assert_array_equal(got[v], want[v], err_msg=v)
            np.testing.assert_array_equal(got[v], _ref(jnets[v], req[v]))
    counts, jcounts = server.dispatch_counts, jserver.dispatch_counts
    assert counts == {k: jcounts[k] for k in counts} and jcounts["sharded"] == 0
    assert counts == {"single": 1, "stacked": 2, "sharded": 0, "fallback": 0}

    names = tuple(sorted(jnets))
    fn, (jfn, _) = server._stacked_fn(names), jserver._stacked_fn(names)
    assert (fn.datapath, fn.launches_per_call) == \
        (jfn.datapath, jfn.launches_per_call) == ("fusednet", 1)
    art, jart = server.compiled_for("v0"), jserver.compiled_for("v0")
    assert (art.artifact.datapath, art.artifact.launches_per_call) == \
        (jart.artifact.datapath, jart.artifact.launches_per_call) == ("planes", 2)


def test_netserver_falls_back_when_versions_cannot_stack():
    server = netgen.NetServer(session=netgen.Session(device="cpu"),
                              target="cuda[planes=true]", slot_capacity=4,
                              warmup=False)
    a, b = random_net(70, (16, 5)), random_net(71, (16, 7))   # class counts differ
    server.register("a", _port(a))
    server.register("b", _port(b))
    x = images(70, 6, 16)
    out = server.predict_many({"a": x, "b": x})
    np.testing.assert_array_equal(out["a"], _ref(a, x))
    np.testing.assert_array_equal(out["b"], _ref(b, x))
    assert server.dispatch_counts["fallback"] == 1
    assert server.predict_many({"a": x[:0], "b": x[:0]})["a"].shape == (0,)
    server.unregister("b")
    with pytest.raises(KeyError):
        server.predict("b", x)


def test_stacked_planes_fall_back_to_chain_when_kernel_refuses(monkeypatch):
    """planes=true prefers the megakernel but takes the per-layer chain
    when the megakernel build raises; fusednet=true is strict."""
    from repro_torch.netgen.backends import cuda
    jnets = _pruned_versions()
    plan = netgen.stack_plans([
        netgen.lower_circuit(netgen.PipelineSpec.coerce(None).run(
            netgen.lower(_port(n)))[0]) for n in jnets.values()])
    monkeypatch.setattr(ops, "SMEM_LIMIT", 64)      # the megakernel's shared-memory refusal
    fn = cuda.compile_cuda_multi(plan, device=torch.device("cpu"), planes=True)
    assert (fn.datapath, fn.launches_per_call) == ("planes", 2 * 3)
    x = np.stack([images(80 + m, 5, 40) for m in range(3)])
    got = fn(x)
    for m, net in enumerate(jnets.values()):
        np.testing.assert_array_equal(got[m].numpy(), _ref(net, x[m]))
    with pytest.raises(ValueError):
        cuda.compile_cuda_multi(plan, device=torch.device("cpu"), fusednet=True)


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        netgen.Session()
    with pytest.raises(RuntimeError):
        netgen.NetServer(target="cuda[planes=true]")
    with pytest.raises(RuntimeError):
        quantize.predict_quantized(_port(random_net(1, (8, 3))))
    with pytest.raises(ValueError):
        netgen.Session(device="meta")
    assert netgen.Session(device="cpu").device == torch.device("cpu")


def _port_modules():
    pkg = ROOT / "src" / "repro_torch"
    return sorted(
        ".".join(("repro_torch", *p.relative_to(pkg).with_suffix("").parts))
        .removesuffix(".__init__")
        for p in pkg.rglob("*.py"))


def test_port_imports_without_jax_or_repro(tmp_path):
    """Every module of the port, `chip_smoke.py`, and the store linter's
    CLI (`python -m repro_torch.netgen.analysis`) run with `jax` and
    `repro` blocked."""
    mods = _port_modules()
    assert {"repro_torch.netgen.backends.cuda", "repro_torch.netgen.engine",
            "repro_torch.netgen.telemetry", "repro_torch.core.netgen"} <= set(mods)
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import chip_smoke\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    store = tmp_path / "store"
    netgen.Session(device="cpu", store=store).compile(
        _port(random_net(3, (12, 9, 4))), target="cuda[planes=true]")
    cli = (
        "import sys, runpy\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"sys.argv = ['analysis', {str(store)!r}]\n"
        "runpy.run_module('repro_torch.netgen.analysis', run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", cli], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "linted 1 artifact(s): 1 ok, 0 failed" in out.stdout


def test_port_sources_name_no_jax_or_repro():
    files = list((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for f in files:
        for line in f.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                mod = words[1].split(".")[0]
                assert mod not in ("jax", "jaxlib", "repro"), (f, line)


@pytest.mark.parametrize("depth", [17, 33])
def test_fusednet_serves_nets_deeper_than_sixteen_layers(depth):
    """`cuda[fusednet=true]` takes any depth whose activations fit shared
    memory: a width-16 net of 17 or 33 layers, built on the CPU, equals
    JAX's `pallas[fusednet=true,interpret=true]` and `predict_quantized`."""
    jnet = random_net(90 + depth, (16,) * depth + (5,), lo=-4, hi=6)
    x = images(90 + depth, 8, 16)
    art = netgen.Session(device="cpu").compile(_port(jnet), target="cuda[fusednet=true]")
    assert (art.artifact.datapath, art.artifact.launches_per_call) == ("fusednet", 1)
    got = art(x).numpy()
    jart = jnetgen.Session().compile(jnet, target="pallas[fusednet=true,interpret=true]")
    np.testing.assert_array_equal(got, np.asarray(jart(jnp.asarray(x))))
    np.testing.assert_array_equal(got, _ref(jnet, x))
