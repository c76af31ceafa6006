"""The port's partition rules and specs (`hsenet_torch.parallel`) against the
JAX package's, with no process group: tensor-parallel specs, FSDP specs,
ZeRO-1 specs, the divisibility check, the mesh-size errors and the data
loader's shards (and, over a word-level tokenizer, one process's ids on
every rank).

The JAX package's Flax kernels are (in, out) and its decoder and tower
layers are stacked on a leading scan axis; the port's weights are (out, in)
and one module per layer. So a JAX spec is carried over by value: each JAX
leaf is filled with a marker that counts along its split axis (constant
elsewhere), the tree goes through `hsenet_torch.bridge.flax_to_torch`, and
the dim along which a port leaf varies is the dim the JAX spec splits. That
dim must be the one the port's spec splits, leaf by leaf, at toy size and at
`VLMConfig()` shapes (markers on shapes cut to 2 per dim; the port's model
on meta tensors), for the float and the int8 LLM.

Two differences are the port's by design and are checked as such: a
column-parallel bias is split with its outputs (the JAX rules leave it
whole), and FSDP's size floor counts one layer in the port where the JAX
package counts the whole scanned stack, so a stacked leaf whose single layer
is below `FSDP_MIN_SIZE` stays whole in the port.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hsenet_tpu.configs as jcfg
import hsenet_tpu.data.datasets as jdata
import hsenet_tpu.parallel.mesh as jmesh
import hsenet_tpu.parallel.sharding as jsh
import hsenet_tpu.parallel.zero as jzero
import hsenet_torch.data.datasets as tdata
import hsenet_torch.parallel.mesh as tmesh
import hsenet_torch.parallel.sharding as tsh
import hsenet_torch.parallel.zero as tzero
from hsenet_tpu.models.lora import quantize_embed_int8, quantize_kernels_int8
from hsenet_tpu.models.mllm import HSENetVLM as JaxVLM
from hsenet_tpu.models.phi3 import Phi3ForCausalLM as JaxLM
from hsenet_torch.bridge import flax_to_torch
from hsenet_torch.models.mllm import HSENetVLM
from hsenet_torch.models.phi3 import Phi3ForCausalLM
from test_torch_common import TINY_LLM, TINY_VLM, to_torch_config

torch.set_num_threads(1)


def port_mesh(dp, tp):
    """The sizes a `DeviceMesh` reports, without a process group."""
    return SimpleNamespace(shape=(dp, tp), mesh_dim_names=("dp", "tp"))


def mapped_dims(shapes, specs, axis, shrink=False):
    """Port name -> the dim split over `axis` (None: whole), carried from
    the JAX specs by value through the bridge."""
    def marker(leaf, spec):
        shape = tuple(min(d, 2) for d in leaf.shape) if shrink else leaf.shape
        dtype = np.int8 if leaf.dtype == jnp.int8 else np.float32
        out = np.zeros(shape, dtype)
        if axis in tuple(spec):
            a = tuple(spec).index(axis)
            view = [1] * len(shape)
            view[a] = shape[a]
            out = out + (np.arange(shape[a]) + 1).reshape(view).astype(dtype)
        return out

    tree = jax.tree.map(marker, shapes, specs)
    dims = {}
    for name, t in flax_to_torch(tree).items():
        varying = [d for d in range(t.dim()) if t.shape[d] > 1
                   and not torch.equal(t, t.narrow(d, 0, 1).expand_as(t))]
        assert len(varying) <= 1, name
        dims[name] = varying[0] if varying else None
    return dims


def port_dims(specs, axis):
    return {n: (s.index(axis) if axis in s else None) for n, s in specs.items()}


def _column_bias(name):
    return name.endswith(".bias") and any(
        f"{p}.bias" in name for p in ("q_proj", "k_proj", "v_proj", "gate_proj",
                                       "up_proj"))


def assert_tp_specs_equal(port_model, jax_params):
    want = mapped_dims(jax_params, jsh.make_param_specs(jax_params), "tp",
                       shrink=isinstance(jax.tree.leaves(jax_params)[0],
                                         jax.ShapeDtypeStruct))
    got = port_dims(tsh.make_param_specs(port_model), "tp")
    assert set(want) <= set(got)
    assert any(d is not None for d in want.values())
    for name, dim in want.items():
        if _column_bias(name):
            assert dim is None and got[name] == 0, name
        else:
            assert got[name] == dim, (name, got[name], dim)


def _llm_params(cfg, seed=0):
    ids = jnp.zeros((1, 4), jnp.int32)
    return jax.tree.map(np.asarray, JaxLM(cfg).init(jax.random.PRNGKey(seed), ids))


def _port_llm(cfg):
    return Phi3ForCausalLM(to_torch_config(cfg), dtype=torch.float32, device="meta")


TOY_LLMS = {
    "tied-lora": TINY_LLM,
    "untied": dataclasses.replace(TINY_LLM, tie_word_embeddings=False),
    "bias": dataclasses.replace(TINY_LLM, attention_bias=True),
}


@pytest.mark.parametrize("name", list(TOY_LLMS))
def test_tp_specs_match_jax_at_toy_size(name):
    cfg = TOY_LLMS[name]
    assert_tp_specs_equal(_port_llm(cfg), _llm_params(cfg)["params"])


def test_tp_specs_of_int8_leaves_match_jax():
    params = _llm_params(TINY_LLM)["params"]
    qparams = quantize_embed_int8(quantize_kernels_int8(params))
    qcfg = dataclasses.replace(TINY_LLM, quant_int8=True, quant_int8_embed=True)
    assert_tp_specs_equal(_port_llm(qcfg), qparams)
    specs = tsh.make_param_specs(_port_llm(qcfg))
    assert specs["decoder.layers.0.down_proj.weight_scale"] == ()
    assert specs["decoder.layers.0.up_proj.weight_scale"] == ("tp",)
    assert specs["embed.scale"] == ("tp",)


def test_tp_specs_of_the_vlm_leave_towers_whole():
    jm = JaxVLM(TINY_VLM, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.ones((1, 12), jnp.int32),
        jnp.ones((1, 1, 4, 16, 16)), jnp.ones((1, 2, 16))))
    model = HSENetVLM(to_torch_config(TINY_VLM), dtype=torch.float32,
                      device="meta")
    assert_tp_specs_equal(model, params["params"])
    split = [n for n, s in tsh.make_param_specs(model).items() if s]
    assert split and all(n.startswith("llm.") for n in split)


@pytest.fixture(scope="module")
def production():
    """The JAX VLMConfig()'s abstract params (float LLM with LoRA, and the
    int8 serving LLM) and the port's models on meta tensors."""
    llm = jcfg.Phi3Config(lora=jcfg.LoRAConfig(rank=16, alpha=32, dropout_rate=0.0))
    cfgs = {"float": jcfg.VLMConfig(llm=llm),
            "int8": jcfg.VLMConfig(llm=dataclasses.replace(
                llm, lora=None, quant_int8=True, quant_int8_embed=True))}
    out = {}
    for name, cfg in cfgs.items():
        shapes = jax.eval_shape(
            JaxVLM(cfg, dtype=jnp.bfloat16).init, jax.random.PRNGKey(0),
            jax.ShapeDtypeStruct((1, 300), jnp.int32),
            jax.ShapeDtypeStruct((1, 1, 32, 256, 256), jnp.float32),
            jax.ShapeDtypeStruct((1, 32, 768), jnp.float32))["params"]
        out[name] = (shapes, HSENetVLM(to_torch_config(cfg), dtype=torch.bfloat16,
                                       device="meta"))
    return out


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_tp_specs_match_jax_at_production_shapes(production, kind):
    shapes, model = production[kind]
    assert_tp_specs_equal(model, shapes)


@pytest.mark.parametrize("tp", [2, 3, 4, 8])
def test_validate_divisibility_raises_where_jax_raises(production, tp):
    shapes, model = production["float"]
    jax_mesh = SimpleNamespace(axis_names=("dp", "tp"),
                               devices=np.empty((1, tp)))
    try:
        jsh.validate_divisibility(shapes, jax_mesh)
        jax_raised = False
    except ValueError:
        jax_raised = True
    assert jax_raised == (tp == 3)
    if jax_raised:
        with pytest.raises(ValueError, match="not divisible by mesh axis tp"):
            tsh.validate_divisibility(model, port_mesh(1, tp))
    else:
        tsh.validate_divisibility(model, port_mesh(8 // tp, tp))


def _fsdp_compare(shapes, model, dp, tp, min_size, stacked_floor=False):
    jax_mesh = SimpleNamespace(shape={"dp": dp, "tp": tp})
    jspecs = jsh.make_fsdp_specs(shapes, jax_mesh, min_size=min_size)
    shrink = isinstance(jax.tree.leaves(shapes)[0], jax.ShapeDtypeStruct)
    want_dp = mapped_dims(shapes, jspecs, "dp", shrink)
    want_tp = mapped_dims(shapes, jspecs, "tp", shrink)
    specs = tsh.make_fsdp_specs(model, port_mesh(dp, tp), min_size=min_size)
    got_dp, got_tp = port_dims(specs, "dp"), port_dims(specs, "tp")
    sizes = {n: t.numel() for n, t in model.state_dict(keep_vars=True).items()}
    floor_only = []
    for name, dim in want_dp.items():
        if not _column_bias(name):
            assert got_tp[name] == want_tp[name], name
        if stacked_floor and sizes[name] < min_size and dim is not None:
            floor_only.append(name)
            assert got_dp[name] is None, name
            continue
        assert got_dp[name] == dim, (name, got_dp[name], dim)
    return floor_only


def test_fsdp_specs_match_jax_at_toy_size():
    jm = JaxVLM(TINY_VLM, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.ones((1, 12), jnp.int32),
        jnp.ones((1, 1, 4, 16, 16)), jnp.ones((1, 2, 16))))["params"]
    model = HSENetVLM(to_torch_config(TINY_VLM), dtype=torch.float32,
                      device="meta")
    assert _fsdp_compare(params, model, dp=4, tp=2, min_size=0) == []
    specs = tsh.make_fsdp_specs(model, port_mesh(4, 2), min_size=0)
    assert specs["llm.decoder.layers.0.q_proj.weight"] == ("tp", "dp")
    assert specs["llm.embed.weight"] == ("tp", "dp")


def test_fsdp_specs_match_jax_at_production_shapes(production):
    shapes, model = production["float"]
    floor_only = _fsdp_compare(shapes, model, dp=8, tp=1,
                               min_size=tsh.FSDP_MIN_SIZE, stacked_floor=True)
    # only per-layer leaves of stacked blocks fall under the floor here
    assert floor_only and all(".layers." in n or ".blocks." in n
                              for n in floor_only)


def test_fsdp_specs_of_int8_leaves_match_jax(production):
    """The int8 codes and their scales (buffers in the port, params in the
    JAX package) take the JAX package's FSDP specs: at toy size every leaf
    (`min_size=0`), at `VLMConfig()` shapes those above the floor."""
    jm = JaxVLM(TINY_VLM, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.ones((1, 12), jnp.int32),
        jnp.ones((1, 1, 4, 16, 16)), jnp.ones((1, 2, 16))))["params"]
    params["llm"] = quantize_embed_int8(quantize_kernels_int8(params["llm"]))
    qcfg = dataclasses.replace(TINY_VLM, llm=dataclasses.replace(
        TINY_VLM.llm, quant_int8=True, quant_int8_embed=True))
    model = HSENetVLM(to_torch_config(qcfg), dtype=torch.float32, device="meta")
    assert _fsdp_compare(params, model, dp=2, tp=2, min_size=0) == []
    specs = tsh.make_fsdp_specs(model, port_mesh(2, 2), min_size=0)
    assert specs["llm.decoder.layers.0.q_proj.weight_q"] == ("tp", "dp")
    assert specs["llm.decoder.layers.0.o_proj.weight_scale"] == ("dp",)
    assert specs["llm.embed.embedding_q"] == ("tp", "dp")
    shapes, model = production["int8"]
    floor_only = _fsdp_compare(shapes, model, dp=8, tp=1,
                               min_size=tsh.FSDP_MIN_SIZE, stacked_floor=True)
    assert all(".layers." in n or ".blocks." in n for n in floor_only)
    specs = tsh.make_fsdp_specs(model, port_mesh(8, 1))
    assert "dp" in specs["llm.decoder.layers.0.down_proj.weight_q"]
    assert "dp" in specs["llm.embed.embedding_q"]


def test_zero1_spec_for_matches_jax():
    rng = np.random.default_rng(0)
    shapes = [(), (7,), (8,), (3, 5), (6, 4), (4, 6), (1, 2), (9, 12, 2)]
    shapes += [tuple(int(x) for x in rng.integers(1, 20, rng.integers(1, 4)))
               for _ in range(30)]
    for dp in (2, 3, 4, 8):
        for shape in shapes:
            leaf = np.zeros(shape)
            assert tzero.zero1_spec_for(leaf, dp) == tuple(
                jzero.zero1_spec_for(leaf, dp)), (shape, dp)


class _Indexed:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"idx": np.asarray(i)}

    get = __getitem__


@pytest.mark.parametrize("shards", [1, 2, 3])
def test_data_loader_shards_match_jax(shards):
    for index in range(shards):
        loaders = [mod.DataLoader(_Indexed(23), 3, shuffle=True, seed=4,
                                  num_shards=shards, shard_index=index)
                   for mod in (jdata, tdata)]
        assert len(loaders[0]) == len(loaders[1])
        for _ in range(2):  # two epochs
            rows = [[np.asarray(b["idx"]).tolist() for b in ld] for ld in loaders]
            assert rows[0] == rows[1]
    with pytest.raises(ValueError, match="shard_index"):
        tdata.DataLoader(_Indexed(4), 2, num_shards=2, shard_index=2)


def _captions(tokenizer):
    reports = [" ".join(f"w{i}x{j}" for j in range(5)) + "." for i in range(10)]
    return tdata.SyntheticCTDataset(
        n=10, shape=(1, 2, 4, 4), tokenizer=tokenizer, mode="caption",
        args=tdata.DataArgs(max_length=40, proj_out_num=2), num_slices=2,
        slice_dim=4, reports=reports)


def test_data_loader_ranks_number_words_as_one_process():
    """Over a dataset whose tokenizer numbers words as it first sees them,
    each rank reads the whole global batch: its rows' ids and its
    vocabulary are one process's. Another dataset is read row by row."""
    one_tok = tdata.SimpleTokenizer()
    one = tdata.DataLoader(_captions(one_tok), 4, seed=1)
    ranks = [tdata.DataLoader(_captions(tdata.SimpleTokenizer()), 2, seed=1,
                              num_shards=2, shard_index=r) for r in range(2)]
    for _ in range(2):  # two epochs
        want = [b["input_ids"] for b in one]
        got = [[b["input_ids"] for b in ld] for ld in ranks]
        assert len(want) == len(got[0]) == len(got[1]) == 2
        for k, rows in enumerate(want):
            for r in range(2):
                np.testing.assert_array_equal(got[r][k], rows[r::2])
    for ld in ranks:
        assert ld.dataset.tokenizer._tokens == one_tok._tokens
    reads = []

    class Counted(_Indexed):
        def __getitem__(self, i):
            reads.append(i)
            return super().__getitem__(i)

    assert len(list(tdata.DataLoader(Counted(8), 2, num_shards=2,
                                     shard_index=0))) == 2
    assert len(reads) == 4


def test_mesh_sizes_without_a_group():
    assert tmesh.create_mesh(jcfg_to_port(dp=-1, tp=1)) is None
    assert tmesh.create_mesh(jcfg_to_port(dp=1, tp=1)) is None
    one = jax.devices()[:1]
    for dp, tp in ((2, 1), (-1, 2), (1, 2)):
        with pytest.raises(AssertionError) as jax_err:
            jmesh.create_mesh(jcfg.MeshConfig(dp=dp, tp=tp), devices=one) \
                if dp > 0 else _jax_dp_rest(tp, one)
        with pytest.raises(ValueError) as port_err:
            tmesh.create_mesh(jcfg_to_port(dp=dp, tp=tp))
        assert str(port_err.value) == str(jax_err.value)
    # the (dp, pp) and (dp, sp) meshes: their sizes, and pp / sp composed
    # with tp or with each other, raise the JAX asserts' messages
    for kw in ({"dp": 1, "pp": 2}, {"dp": 1, "sp": 2}, {"dp": 2, "pp": 2},
               {"dp": 1, "pp": 2, "tp": 2}, {"dp": 1, "sp": 2, "tp": 2},
               {"dp": 1, "pp": 2, "sp": 2}):
        with pytest.raises(AssertionError) as jax_err:
            jmesh.create_mesh(jcfg.MeshConfig(**kw), devices=one)
        with pytest.raises(ValueError) as port_err:
            tmesh.create_mesh(jcfg_to_port(**kw))
        assert str(port_err.value) == str(jax_err.value)


def _jax_dp_rest(tp, devices):
    """JAX's create_mesh at dp = -1 on too few devices takes dp = 0 and
    fails later; the port raises its mesh-size message there, which is the
    message JAX's assert gives for a 1 x tp mesh."""
    return jmesh.create_mesh(jcfg.MeshConfig(dp=1, tp=tp), devices=devices)


def jcfg_to_port(**kw):
    from hsenet_torch.configs import MeshConfig

    return MeshConfig(**kw)
