"""The port's weights for serving, on the CPU at the `configs.smoke(...)`
size: the reference's bf16 serving copy carried in (`models/convert.py`),
the serving cast (`base.serving_copy`), the layered draw
(`base.tree_draw`), the W8 quantization of a layer slice
(`quantized/apply.py` `serving_leaf`), and the launcher's draw of each
rank's own shards (`launch/serve.py` `draw_params`, `tensor.draw_keep`).

(a) `from_jax_params` carries a bfloat16 leaf bit for bit. (b) On one
bf16 serving copy, drawn by JAX and cast by the reference's rule, the
port's `api.forward`, `api.prefill` and `Engine.generate` against the
reference's: fp32 compute within 1e-4 absolute (summation order), bf16
compute within 2 x 2**-7 of the largest |logit| (one bf16 rounding of
the activations a layer, read at ~0.007 of it), greedy tokens equal in
fp32. In bf16 a MoE router's input is rounded, which can flip a top-k
choice near a tie, and a flipped choice moves its token's logits (and
those after it) by far more than a rounding; either package flips where
the other may not. Read over 6 weight seeds at this size: 0-9 of 48
positions beyond the bound, up to 0.25 of the largest |logit|, while
each package's own bf16 logits miss its fp32 ones by up to 0.16. So a
MoE model's bf16 logits are held position by position: at least 3/4 of
them within the bound, and every one within the larger of the bound and
3 x that witness (the larger of the two packages' own bf16-vs-fp32
gaps), as the card's bf16 MoE holds are (ROADMAP.md, C). The
reference's `tree_init` folds Python's salted `hash` of each path, so
the weights here are drawn by `jax.random` with a stable fold (crc32).
(c) `serving_copy` gives the reference's dtypes. (d) `tree_draw`:
dtypes, layer slices, seeding, the init's spread, the largest fp32
temporary. (e) On gloo worlds of model 2 and of (data 2, model 2)
(`tests/_draw_child.py`), each rank's shards from the launcher's draw
equal `shard_params` of the unmeshed draw bitwise, and no rank makes a
tensor of a cut stacked leaf's whole shape. The dry run's bf16 serving
variant still counts what it counted (`launch.dryrun --serve-opt`).
"""
import dataclasses
import hashlib
import json
import math
import os
import subprocess
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _draw_child import CASES, Allocations, part_bytes, part_shapes
from _gloo_world import spawn
from repro import configs as jconfigs
from repro.launch import dryrun as jdryrun
from repro.models import api as japi
from repro.models import base as jbase
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch import configs
from repro_torch.launch import dryrun, serve
from repro_torch.models import api, base, convert
from repro_torch.quantized import apply
from repro_torch.serve.engine import Engine, ServeConfig

ROOT = Path(__file__).resolve().parents[1]
CHILD = Path(__file__).with_name("_draw_child.py")
FP32_TOL = 1e-4
BF16_RTOL = 2 * 2.0 ** -7
SERVED = ("qwen3-moe-30b-a3b", "granite-moe-1b-a400m", "qwen1.5-4b")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy()


# -- (a) the bf16 carry ---------------------------------------------------------

BF16_LEAVES = {
    "matrix": np.linspace(-3, 3, 12, dtype=np.float32).reshape(3, 4),
    "specials": np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-40, 3.0e38],
                         np.float32),
    "scalar": np.array(1 / 3, np.float32),
    "stacked": np.random.default_rng(0).normal(size=(2, 3, 5)).astype(np.float32),
}


@pytest.mark.parametrize("name", sorted(BF16_LEAVES))
def test_from_jax_params_carries_bf16_bitwise(name):
    """A bfloat16 leaf (the reference's bf16 serving copy) arrives as a
    torch.bfloat16 tensor of the same bits, beside fp32, int8 and W8
    leaves of the same tree."""
    a = BF16_LEAVES[name].astype(ml_dtypes.bfloat16)
    tree = {"w": a, "n": {"scale": np.ones(3, np.float32)},
            "q": {"q": np.arange(6, dtype=np.int8).reshape(2, 3), "s": np.ones(3, np.float32)}}
    got = convert.from_jax_params(tree, device="cpu")
    assert got["w"].dtype == torch.bfloat16 and tuple(got["w"].shape) == a.shape
    np.testing.assert_array_equal(_bits(got["w"]), a.view(np.int16))
    assert got["n"]["scale"].dtype == torch.float32 and got["q"]["q"].dtype == torch.int8
    j = np.asarray(jnp.asarray(BF16_LEAVES[name]).astype(jnp.bfloat16))
    np.testing.assert_array_equal(_bits(convert.from_jax_params({"w": j}, device="cpu")["w"]),
                                  j.view(np.int16))


# -- (b) the reference's bf16 serving copy, served by both packages ----------------

def _jax_draw(jcfg, seed: int = 0):
    """The reference's abstract parameters drawn as its `tree_init` draws
    them (`repro/models/base.py`), each leaf's key folded with the crc32
    of its path instead of Python's salted `hash`."""
    def mk(path, i):
        k = jax.random.fold_in(jax.random.PRNGKey(seed),
                               zlib.crc32(jax.tree_util.keystr(path).encode()))
        if i.init in ("zeros", "ones"):
            return (jnp.zeros if i.init == "zeros" else jnp.ones)(i.shape, i.dtype)
        if i.init == "normal":
            std = i.scale / np.sqrt(max(i.shape[i.fan] if i.shape else 1, 1))
            return (jax.random.normal(k, i.shape) * std).astype(i.dtype)
        return jax.random.uniform(k, i.shape, i.dtype, -i.scale, i.scale)

    return jax.tree_util.tree_map_with_path(mk, japi.abstract_params(jcfg), is_leaf=jbase.is_info)


def _bf16_copy(jcfg):
    """The reference's weights drawn by JAX, cast by its serving rule
    (`_serve_params_sds`): the JAX tree and the same tree in the port."""
    pj = _jax_draw(jcfg)
    sds = jdryrun._serve_params_sds(jcfg, {"serve_dtype": "bfloat16"})
    pj = jax.tree.map(lambda x, s: x.astype(s.dtype), pj, sds)
    return pj, convert.from_jax_params(jax.tree.map(np.asarray, pj), device="cpu")


@pytest.fixture(scope="module", params=SERVED)
def copy(request):
    arch = request.param
    jcfg = dataclasses.replace(jconfigs.smoke(arch), compute_dtype="float32")
    pj, pt = _bf16_copy(jcfg)
    return arch, pj, pt


def _cfgs(arch, compute):
    return (dataclasses.replace(jconfigs.smoke(arch), compute_dtype=compute),
            dataclasses.replace(configs.smoke(arch), compute_dtype=compute))


def _prompts(seed, b, s, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s)).astype(np.int32)


def _held(got, want, compute, witness=None):
    """fp32: within FP32_TOL. bf16: every position within BF16_RTOL of the
    largest |logit|; with a MoE `witness`, at least 3/4 of the positions
    within it and every one within 3 x the witness where that is larger."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want)
    if compute == "float32":
        assert err.max() <= FP32_TOL, err.max()
        return
    rel = err.reshape(-1, err.shape[-1]).max(-1) / np.abs(want).max()
    if witness is None:
        assert rel.max() <= BF16_RTOL, rel.max()
        return
    assert (rel <= BF16_RTOL).mean() >= 0.75, rel
    assert rel.max() <= max(BF16_RTOL, 3 * witness), (rel.max(), witness)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_bf16_copy_forward_and_prefill_match_the_reference(copy, compute):
    """The port's forward and prefill on the reference's bf16 serving copy
    against the reference's forward on it: every logit, and prefill's last
    position, at the same T (a MoE prefill's capacity is the forward's)."""
    arch, pj, pt = copy
    jcfg, cfg = _cfgs(arch, compute)
    assert all(t.dtype == torch.bfloat16 for _, t in base.tree_items(pt["layers"]))
    toks = _prompts(7, 2, 24)

    def ref(c):
        return np.asarray(jax.jit(lambda p, t: japi.forward(c, p, {"tokens": t})[0])(pj, toks),
                          np.float32)

    want = ref(jcfg)

    def port(c):
        with torch.inference_mode():
            return api.forward(c, pt, {"tokens": torch.from_numpy(toks).long()})[0]

    got = port(cfg)
    with torch.inference_mode():
        cache = base.tree_init(api.abstract_cache(cfg, 2, 32), torch.Generator(), "cpu")
        last = api.prefill(cfg, pt, {"tokens": torch.from_numpy(toks).long()}, cache)[0]
    witness = None
    if cfg.family == "moe" and compute == "bfloat16":
        w32 = ref(dataclasses.replace(jcfg, compute_dtype="float32"))
        p32 = port(dataclasses.replace(cfg, compute_dtype="float32")).numpy()
        witness = max(np.abs(want - w32).max(), np.abs(got.float().numpy() - p32).max()) \
            / np.abs(w32).max()
    assert got.shape == want.shape == (2, 24, cfg.vocab)
    _held(got.float().numpy(), want, compute, witness)
    _held(last.float().numpy(), want[:, -1], compute, witness)


def test_bf16_copy_engine_tokens_equal_the_reference(copy):
    """`Engine.generate` on the bf16 copy in fp32 compute: the reference
    engine's greedy tokens (MoE decode steps drop pairs in both)."""
    arch, pj, pt = copy
    jcfg, cfg = _cfgs(arch, "float32")
    prompts = _prompts(5, 3, 12)
    out = Engine(cfg, pt, ServeConfig(max_len=24, max_new_tokens=6),
                 device="cpu").generate(prompts)
    want = JEngine(jcfg, pj, JServeConfig(max_len=24, max_new_tokens=6)).generate(prompts)
    assert out.shape == (3, 6)
    np.testing.assert_array_equal(out, want)


# -- (c) the serving cast ----------------------------------------------------------

@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "bf16_w8"])
@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_serving_copy_gives_the_reference_dtypes(arch, quant):
    """`base.serving_copy`, through the dry run's `_serve_params_tree`,
    against the reference's `_serve_params_sds`: paths, shapes and dtypes
    leaf for leaf (fp32 leaves of two dims or more in bf16, int8 kept)."""
    variant = {"serve_dtype": "bfloat16", **({"quant": True} if quant else {})}
    got = list(base.tree_items(dryrun._serve_params_tree(configs.get_config(arch), variant)))
    want = jax.tree_util.tree_flatten_with_path(
        jdryrun._serve_params_sds(jconfigs.get_config(arch), variant))[0]
    assert [(base.keystr(p), i.shape, str(i.dtype).removeprefix("torch.")) for p, i in got] == \
        [(jax.tree_util.keystr(p), s.shape, np.dtype(s.dtype).name) for p, s in want]
    tree = api.abstract_params(configs.get_config(arch))
    for (_, a), (_, b) in zip(base.tree_items(tree),
                              base.tree_items(base.serving_copy(tree, torch.bfloat16))):
        cast = a.dtype == torch.float32 and len(a.shape) >= 2
        assert b == dataclasses.replace(a, dtype=torch.bfloat16 if cast else a.dtype)


def test_dryrun_serve_opt_counts_what_it_counted(tmp_path):
    """`launch.dryrun --serve-opt` on qwen2-72b decode_32k (fake 16 x 16
    world, rank 0) records what it recorded before the cast rule moved to
    `base.serving_copy`."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    path = tmp_path / "dry.json"
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                           "qwen2-72b", "--shape", "decode_32k", "--serve-opt", "--out",
                           str(path)], env=env, capture_output=True, text=True, timeout=240,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    (rec,) = json.loads(path.read_text())
    assert rec["ok"]
    assert {k: rec[k] for k in ("flops_per_device", "bytes_per_device", "collective_bytes",
                                "peak_mem_per_device", "arg_bytes", "param_bytes",
                                "aten_ops", "rows_per_rank")} == {
        "flops_per_device": 134540689408.0, "bytes_per_device": 59282437384.0,
        "collective_bytes": 55320576.0, "peak_mem_per_device": 27714830440.0,
        "arg_bytes": 16976363584, "param_bytes": 11607654400, "aten_ops": 15661,
        "rows_per_rank": 8}
    assert rec["fallbacks"] == [["kv_heads", 8, ["model"], None]] * 6


# -- (d) the layered draw ------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_tree_draw_dtypes_and_layer_slices(arch):
    """Every leaf in its abstract shape and dtype, fp32 and the bf16
    serving copy; every stacked leaf n_layers deep; the bf16 copy is the
    fp32 draw rounded, slice for slice."""
    cfg = configs.smoke(arch)
    tree = api.abstract_params(cfg)
    fp32 = base.tree_draw(tree, 0, "cpu")
    bf16 = base.tree_draw(base.serving_copy(tree, "bfloat16"), 0, "cpu")
    stacked = 0
    for (path, info), (_, a), (_, b) in zip(base.tree_items(tree), base.tree_items(fp32),
                                            base.tree_items(bf16)):
        assert tuple(a.shape) == tuple(b.shape) == info.shape and a.dtype == info.dtype, path
        assert b.dtype == (torch.bfloat16 if len(info.shape) >= 2 else torch.float32), path
        assert torch.equal(a.to(b.dtype), b), path
        if path[0] == base.STACKED:
            stacked += 1
            assert info.shape[0] == cfg.n_layers, path
    assert stacked >= 5


def test_tree_draw_slices_depend_on_seed_path_and_layer_only():
    """A slice is the same bits drawn in another key order, from a
    sub-tree, or beside other leaves; two seeds differ; a slice of one
    leaf is not the next layer's."""
    tree = api.abstract_params(configs.smoke("qwen3-moe-30b-a3b"))
    whole = dict(base.tree_items(base.tree_draw(tree, 3, "cpu")))

    def reversed_keys(node):
        return {k: reversed_keys(node[k]) for k in sorted(node, reverse=True)} \
            if isinstance(node, dict) else node

    other = dict(base.tree_items(base.tree_draw(reversed_keys(tree), 3, "cpu")))
    sub = base.tree_draw({"layers": {"moe": {"wi": tree["layers"]["moe"]["wi"]}},
                          "embed": {"tok": tree["embed"]["tok"]}}, 3, "cpu")
    for path, t in whole.items():
        assert torch.equal(t, other[path]), path
    assert torch.equal(sub["layers"]["moe"]["wi"], whole[("layers", "moe", "wi")])
    assert torch.equal(sub["embed"]["tok"], whole[("embed", "tok")])
    seed4 = base.tree_draw(tree, 4, "cpu")
    wi = whole[("layers", "moe", "wi")]
    assert not torch.equal(seed4["layers"]["moe"]["wi"], wi)
    assert not torch.equal(seed4["embed"]["tok"], whole[("embed", "tok")])
    assert not torch.equal(wi[0], wi[1])


@pytest.mark.parametrize("stacked", [True, False])
def test_tree_draw_init_spread(stacked):
    """A normal leaf's std is scale / sqrt(fan_in), fan_in the whole
    leaf's (index 1 of a stacked (L, in, out) leaf), within 5%; uniform
    within [-scale, scale]; zeros and ones."""
    L = (4,) if stacked else ()
    fan = 1 if stacked else 0
    tree = {"layers" if stacked else "embed": {
        "w": base.ParamInfo((*L, 300, 200), scale=2.0, fan=fan),
        "u": base.ParamInfo((*L, 300, 200), init="uniform", scale=0.5),
        "z": base.ParamInfo((*L, 7), init="zeros"),
        "o": base.ParamInfo((*L, 7), init="ones")}}
    (got,) = base.tree_draw(tree, 0, "cpu").values()
    parts = list(got["w"]) if stacked else [got["w"]]
    for w in parts:
        assert abs(w.std().item() / (2.0 / math.sqrt(300)) - 1) < 0.05
    assert got["u"].abs().max() <= 0.5 and got["u"].abs().max() > 0.49
    assert (got["z"] == 0).all() and (got["o"] == 1).all()


def test_tree_init_values_are_unchanged():
    """`tree_init`, which the port's tests and the card phases' figures
    read, draws what it drew before the draw's code was shared with
    `tree_draw`: sha256 of every leaf, seed 0, on the CPU."""
    want = {"qwen1.5-4b": "71a4639211b80930", "qwen3-moe-30b-a3b": "56823fdbfcea4541",
            "zamba2-2.7b": "cda6d51b1ec8889c", "mamba2-2.7b": "a36a23bc3c1eb0e7"}
    for arch, digest in want.items():
        params = base.tree_init(api.abstract_params(configs.smoke(arch)),
                                torch.Generator().manual_seed(0), "cpu")
        h = hashlib.sha256()
        for path, t in base.tree_items(params):
            h.update(base.keystr(path).encode())
            h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
        assert h.hexdigest()[:16] == digest, arch


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "qwen1.5-4b", "mamba2-2.7b",
                                  "zamba2-2.7b"])
def test_tree_draw_largest_fp32_temporary_is_one_part(arch):
    """Drawing the bf16 serving copy, no op makes an fp32 tensor larger
    than one layer slice or one unstacked leaf (the largest of them is
    made), and none of a stacked leaf's whole shape in fp32."""
    tree = base.serving_copy(api.abstract_params(configs.smoke(arch)), torch.bfloat16)
    with Allocations() as seen:
        base.tree_draw(tree, 0, "cpu")
    assert seen.largest_fp32 == part_bytes(tree)
    stacked = {i.shape for p, i in base.tree_items(tree) if p[0] == base.STACKED}
    stacked -= part_shapes(tree)          # a shape that a part has too is no witness
    assert stacked and not {(s, torch.float32) for s in stacked} & seen.shapes


def test_serving_leaf_of_slices_is_the_whole_quantization():
    """W8 a slice at a time (`serving_leaf` with the whole leaf's shape)
    gives the whole tree's `q` and `s` bit for bit, for every family;
    whether a leaf is int8 is decided from the whole leaf's shape."""
    for arch in ("qwen3-moe-30b-a3b", "mamba2-2.7b", "zamba2-2.7b", "qwen1.5-4b"):
        cfg = configs.smoke(arch)
        tree = api.abstract_params(cfg)
        whole = apply.quantize_params_for_serving(cfg, base.tree_draw(tree, 0, "cpu"),
                                                  min_size=0)
        sliced = base.tree_draw(tree, 0, "cpu", keep=lambda path, info, part, i:
                                apply.serving_leaf(base.keystr(path), part, shape=info.shape,
                                                   min_size=0))
        got, want = dict(base.tree_items(sliced)), dict(base.tree_items(whole))
        assert sorted(got) == sorted(want)
        assert any(p[-1] == "q" for p in got)
        for path, t in want.items():
            assert t.dtype == got[path].dtype and torch.equal(t, got[path]), (arch, path)
    x = torch.ones(4, 100)
    with pytest.raises(ValueError, match="scales span its layers"):
        apply.serving_leaf("['layers']['wq']", x[0], shape=(4, 100), min_size=0)
    assert torch.equal(apply.serving_leaf("['layers']['wq']", x[0], shape=(4, 1, 100),
                                          min_size=1000), x[0])


# -- (e) each rank's own shards --------------------------------------------------

@pytest.fixture(scope="module", params=[2, 4], ids=["model2", "data2_model2"])
def ranks(request, tmp_path_factory):
    d = tmp_path_factory.mktemp(f"draw{request.param}")
    return spawn(CHILD, request.param, d)


@pytest.mark.parametrize("case", [f"{a}/{'w8' if w8 else 'fp32'}" for a, w8 in CASES])
def test_launcher_draw_keeps_each_ranks_shards(ranks, case):
    """Every rank's shards from the launcher's meshed draw (each slice cut
    as it is drawn; W8 slices quantized whole first) equal `shard_params`
    of the unmeshed draw, leaf for leaf, bitwise; the largest storage an
    op made is one fp32 part or one shard, never a cut stacked leaf's
    whole shape; the W8 MoE tree's prefill raises as the reference's."""
    for z in ranks:
        got = {k[len(case) + 5:]: v for k, v in z.items() if k.startswith(f"{case}/got/")}
        want = {k[len(case) + 6:]: v for k, v in z.items() if k.startswith(f"{case}/want/")}
        assert got and sorted(got) == sorted(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
        largest, largest_fp32, part, shards = z[f"{case}/bytes"]
        assert largest <= max(part, shards) and largest_fp32 <= max(part, shards)
        assert z[f"{case}/cut_shapes"] > 0 and not z[f"{case}/whole_cut_leaf_made"]
        if case.endswith("/w8"):
            assert any(k.endswith("['q']") for k in got)
        if case == "granite-moe-1b-a400m/w8":
            assert "W8 expert weights are not served" in str(z[f"{case}/refused"])
    coords = sorted(tuple(z["coordinate"]) for z in ranks)
    assert len(set(coords)) == len(ranks)
