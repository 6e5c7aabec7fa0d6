"""The port's sharding rules, elastic plan, gradient compression, model
flops and dry-run bytes against the reference's, on the CPU, with no
process group.

The rules are compared leaf by leaf (path name, then spec, with ``==``
between the port's tuple and the reference's ``PartitionSpec``) over the
reference's ``jax.eval_shape`` trees and the port's meta trees of every
config at full size: params, LoRA, AdamW moments and the decode cache, on
the meshes of ``MESHES``, with and without ``cfg``. The reference reads
only ``mesh.shape``; it is called with a stand-in whose ``.shape`` is the
axis dict. ``compress_decompress`` is held to the reference over three
error-feedback steps bit for bit (the same f32 division, round half to
even and clip); ``plan_mesh``, ``wire_bytes`` and ``model_flops`` exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.distributed import compression as jcompression
from repro.distributed import elastic as jelastic
from repro.distributed import sharding as jsharding
from repro.launch import specs as jspecs
from repro_torch import configs
from repro_torch.distributed import compression, elastic, sharding
from repro_torch.launch import dryrun, specs
from repro_torch.launch import mesh as launch_mesh
from repro_torch.tree import flatten_with_names

MESHES = ({"data": 1, "model": 1}, {"data": 2, "model": 2}, {"data": 1, "model": 4},
          {"data": 4, "model": 1}, {"data": 16, "model": 16},
          {"pod": 2, "data": 16, "model": 16})


class _Mesh:
    """What the reference's rules read of a mesh."""

    def __init__(self, shape):
        self.shape = shape


def _key(k) -> str:
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def _ref_specs(tree) -> list[tuple[str, tuple]]:
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return [("/".join(_key(k) for k in path), spec) for path, spec in flat]


def _assert_same(ref_tree, port: dict):
    ref = _ref_specs(ref_tree)
    assert [n for n, _ in ref] == list(port)
    for (name, want), got in zip(ref, port.values()):
        assert got == want and len(got) == len(want), (name, got, want)


@functools.lru_cache(maxsize=None)
def _trees(arch: str) -> dict:
    """{kind: (reference tree, port tree)} of ``arch`` at full size."""
    train, decode = (jconfigs.get_shape(s) for s in ("train_4k", "decode_32k"))
    jtrain = jspecs.model_state_specs(jconfigs.get(arch), train)["train_state"]
    jdec = jspecs.model_state_specs(jconfigs.get(arch), decode)
    cfg = configs.get(arch)
    ttrain = specs.model_state_specs(cfg, configs.get_shape("train_4k"))["train_state"]
    tdec = specs.model_state_specs(cfg, configs.get_shape("decode_32k"))
    return {"params": (jtrain.params, ttrain.params), "lora": (jtrain.lora, ttrain.lora),
            "moments": (jtrain.opt.m, ttrain.opt.m), "cache": (jdec["cache"], tdec["cache"])}


@pytest.mark.parametrize("kind", ["params", "lora", "moments", "cache"])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_specs_match_the_reference(arch, kind):
    """Every leaf's spec, with and without ``cfg`` where the rule takes one."""
    jtree, ttree = _trees(arch)[kind]
    assert [tuple(t.shape) for _, t in flatten_with_names(ttree)] == \
        [tuple(a.shape) for a in jax.tree.leaves(jtree)]
    for mesh in MESHES:
        m = _Mesh(mesh)
        if kind == "cache":
            _assert_same(jsharding.cache_specs(jtree, m), sharding.cache_specs(ttree, mesh))
            continue
        for use_cfg in (False, True):
            jc, tc = (jconfigs.get(arch), configs.get(arch)) if use_cfg else (None, None)
            if kind == "moments":
                _assert_same(jsharding.moment_specs(jtree, m, jc),
                             sharding.moment_specs(ttree, mesh, tc))
            else:
                _assert_same(jsharding.param_specs(jtree, m, jc),
                             sharding.param_specs(ttree, mesh, tc))


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_batch_specs_match_the_reference(arch):
    for shape in configs.shape_cells(arch):
        jb = jspecs.batch_specs_for(jconfigs.get(arch), jconfigs.get_shape(shape.name))
        tb = specs.batch_specs_for(configs.get(arch), shape)
        assert [(n, tuple(t.shape)) for n, t in flatten_with_names(tb)] == \
            [(n, tuple(a.shape)) for n, a in flatten_with_names(jb)]
        assert [t.dtype for _, t in flatten_with_names(tb)] == \
            [getattr(torch, jnp.dtype(a.dtype).name) for _, a in flatten_with_names(jb)]
        for mesh in MESHES:
            _assert_same(jsharding.batch_specs(jb, _Mesh(mesh)), sharding.batch_specs(tb, mesh))


def test_a_port_tree_is_meta_and_the_dense_ffn_layer_axis_is_sharded():
    """The meta trees allocate nothing; and the reference's rule that the
    port keeps: a layer-stacked dense FFN weight shards its layer axis."""
    ts = specs.model_state_specs(configs.get("qwen3-0.6b"),
                                 configs.get_shape("train_4k"))["train_state"]
    assert all(t.device.type == "meta" for _, t in flatten_with_names(ts))
    got = sharding.param_specs(ts.params, {"data": 2, "model": 2})
    assert got["layers/ffn/w_gate"] == ("model", None, None)  # 28 layers over 2
    assert got["layers/mixer/wq"] == (None, None, "model")


def test_shardings_give_local_shapes_and_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = {"pod": 2, "data": 4, "model": 2}
    sh = sharding.make_shardings({"a": (("pod", "data"), None, "model"), "b": ()}, mesh)
    assert sh["a"].local_shape((16, 3, 8)) == (2, 3, 4)
    assert sh["a"].placements() == (Shard(0), Shard(0), Shard(2))
    assert sh["b"].local_shape((5, 7)) == (5, 7)
    assert sh["b"].placements() == (Replicate(),) * 3


def test_production_mesh_axes_and_its_refusal_without_the_ranks():
    assert launch_mesh.production_axes() == {"data": 16, "model": 16}
    assert launch_mesh.production_axes(multi_pod=True) == {"pod": 2, "data": 16, "model": 16}
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        launch_mesh.make_production_mesh(device_type="cpu")


@pytest.mark.parametrize("divisor", [None, 32])
@pytest.mark.parametrize("preferred", [1, 2, 4, 16])
def test_plan_mesh_matches_the_reference(preferred, divisor):
    for n in range(1, 65):
        want = jelastic.plan_mesh(n, preferred_model=preferred, model_divisor_of=divisor)
        got = elastic.plan_mesh(n, preferred_model=preferred, model_divisor_of=divisor)
        assert (got.data, got.model, got.dropped_devices, got.size) == \
            (want.data, want.model, want.dropped_devices, want.size), n


def test_plan_mesh_cases_of_the_reference_tests():
    """tests/test_distributed.py's elastic cases."""
    for n, pm, div in ((512, 16, None), (248, 16, 32), (3, 16, None)):
        want = jelastic.plan_mesh(n, preferred_model=pm, model_divisor_of=div)
        got = elastic.plan_mesh(n, preferred_model=pm, model_divisor_of=div)
        assert (got.data, got.model, got.dropped_devices) == \
            (want.data, want.model, want.dropped_devices)
    p = elastic.plan_mesh(512, preferred_model=16)
    assert (p.data, p.model, p.dropped_devices) == (32, 16, 0)
    p = elastic.plan_mesh(248, preferred_model=16, model_divisor_of=32)
    assert p.size <= 248 and 32 % p.model == 0 and p.size >= 240


def _grad_tree(seed: int):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((6, 9)).astype(np.float32) * 3
    w[2] = 0.0  # an all-zero row: scale 1, error 0
    w[4, :4] = (127.0, 2.5, -3.5, 0.5)  # scale 1: halves, rounded to even
    return {"w": w, "b": rng.standard_normal((5,)).astype(np.float32),
            "s": np.float32(rng.standard_normal()),  # 0-d: passed through
            "stack": (rng.standard_normal((2, 3, 4)).astype(np.float32),)}


def _torch_tree(tree):
    return {k: (tuple(torch.from_numpy(x) for x in v) if isinstance(v, tuple)
                else torch.from_numpy(np.asarray(v))) for k, v in tree.items()}


def test_compress_decompress_matches_the_reference_bitwise():
    """Three error-feedback steps of a seeded tree (a 0-d leaf, an all-zero
    row): the dequantized gradients and the residuals bit for bit."""
    jst = jcompression.init_state(jax.tree.map(jnp.asarray, _grad_tree(0)))
    tst = compression.init_state(_torch_tree(_grad_tree(0)))
    for step in range(3):
        g = _grad_tree(step)
        jout, jst = jcompression.compress_decompress(jax.tree.map(jnp.asarray, g), jst)
        tout, tst = compression.compress_decompress(_torch_tree(g), tst)
        for tree_t, tree_j in ((tout, jout), (tst.error, jst.error)):
            got, want = flatten_with_names(tree_t), flatten_with_names(tree_j)
            assert [n for n, _ in got] == [n for n, _ in want]
            for (n, t), (_, a) in zip(got, want):
                assert t.dtype == torch.float32 and tuple(t.shape) == a.shape, n
                assert np.array_equal(t.numpy(), np.asarray(a)), (step, n)
    assert float(tst.error["s"]) == 0.0


def test_wire_bytes_match_the_reference():
    g = _grad_tree(1)
    g["h"] = np.zeros((3, 4, 8), np.float16)
    for compressed in (False, True):
        assert compression.wire_bytes(_torch_tree(g), compressed) == \
            jcompression.wire_bytes(jax.tree.map(jnp.asarray, g), compressed)


def _ref_bytes(tree, spec_tree, mesh: dict) -> int:
    """Per-device bytes from the reference's specs: each dim divided by the
    product of its axes' sizes."""
    total = 0
    for a, (_, spec) in zip(jax.tree.leaves(tree), _ref_specs(spec_tree)):
        n = 1
        for d, s in enumerate(a.shape):
            axes = spec[d] if d < len(spec) else None
            axes = () if axes is None else (axes if isinstance(axes, tuple) else (axes,))
            n *= s // int(np.prod([mesh[x] for x in axes]))
        total += n * jnp.dtype(a.dtype).itemsize
    return total


@pytest.mark.parametrize("arch,shape,mesh", [("qwen3-0.6b", "train_4k", "pod1"),
                                             ("gemma-2b", "decode_32k", "pod2"),
                                             ("phi3.5-moe-42b-a6.6b", "prefill_32k", "pod1")])
def test_dryrun_device_bytes_match_the_reference_specs(arch, shape, mesh):
    rec = dryrun.run_cell(arch, shape, mesh)
    axes = {"pod": 2, "data": 16, "model": 16} if mesh == "pod2" else {"data": 16, "model": 16}
    m = _Mesh(axes)
    st = jspecs.model_state_specs(jconfigs.get(arch), jconfigs.get_shape(shape))
    if "train_state" in st:
        ts = st["train_state"]
        params, lora = ts.params, ts.lora
        assert rec["moment_bytes_per_device"] == sum(
            _ref_bytes(t, jsharding.moment_specs(t, m), axes) for t in (ts.opt.m, ts.opt.v))
    else:
        params, lora = st["params"], st["lora"]
    if "cache" in st:
        assert rec["cache_bytes_per_device"] == _ref_bytes(
            st["cache"], jsharding.cache_specs(st["cache"], m), axes)
    assert rec["param_bytes_per_device"] == _ref_bytes(params, jsharding.param_specs(params, m),
                                                       axes)
    assert rec["lora_bytes_per_device"] == _ref_bytes(lora, jsharding.param_specs(lora, m), axes)
    assert rec["model_flops"] == jspecs.model_flops(jconfigs.get(arch),
                                                    jconfigs.get_shape(shape))
