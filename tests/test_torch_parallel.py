"""Port: the mesh, the sharding rules, the sharded qmatmul and the slot-sharded,
block-keyed serving tick against the JAX package, in one process.

The JAX side runs on conftest's 8-device CPU mesh with its Pallas kernels
in interpret mode. The port's placement rules read only the mesh's sizes and
this rank's coordinates, so each rank of a port mesh is simulated here by a
``Mesh`` at that coordinate, and its collectives by concatenating the
simulated ranks' results in coordinate order (what ``all_gather`` returns).
The real collectives run in ``tests/test_torch_multihost.py``.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from ggml_experiments_tpu import quant as jquant
from ggml_experiments_tpu.models import gru_textgen as jg
from ggml_experiments_tpu.parallel import make_mesh as jmake_mesh
from ggml_experiments_tpu.parallel import sharding as jsharding
from ggml_experiments_tpu.serving import engine as jengine
from ggml_experiments_tpu_torch.convert import params_from_numpy
from ggml_experiments_tpu_torch.models.gru_textgen import GRUConfig, init_params
from ggml_experiments_tpu_torch.ops import fused_gru_decode as tf
from ggml_experiments_tpu_torch.parallel import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    P,
    axis_slice,
    gru_param_specs,
    infer_mesh_shape,
    make_mesh,
    place,
)
from ggml_experiments_tpu_torch.parallel import sharding as tsharding
from ggml_experiments_tpu_torch.quant.qtensor import PLANE_NAMES
from ggml_experiments_tpu_torch.serving import engine as tengine

jf = importlib.import_module("ggml_experiments_tpu.ops.fused_gru_decode")
# the quant package re-exports a function under the module's name
tqm = importlib.import_module("ggml_experiments_tpu_torch.quant.qmatmul")

V, E, U = 66, 32, 64


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"
    return jmake_mesh((2, 4))


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def jax_planes(jq):
    out = {"shape": jq.shape, "qtype": jq.qtype}
    for name in PLANE_NAMES:
        if getattr(jq, name) is not None:
            out[name] = np.asarray(getattr(jq, name))
    return out


def sim_meshes(shape, axis):
    """One simulated rank of each coordinate along ``axis`` (the other at 0)."""
    at = (DATA_AXIS, MODEL_AXIS).index(axis)
    return [Mesh(shape, tuple(r if i == at else 0 for i in range(2)))
            for r in range(shape[at])]


def test_infer_mesh_shape_matches_jax():
    from ggml_experiments_tpu.parallel import infer_mesh_shape as jinfer

    assert infer_mesh_shape(8) == (1, 8)
    assert infer_mesh_shape(16) == (2, 8)
    assert infer_mesh_shape(2) == (1, 2)
    assert infer_mesh_shape(1) == (1, 1)
    for n in range(1, 65):
        for mm in (1, 2, 4, 8):
            assert infer_mesh_shape(n, mm) == jinfer(n, mm), (n, mm)


def test_make_mesh_bad_shape_and_one_rank():
    with pytest.raises(ValueError, match="mesh shape"):
        make_mesh((3, 5), device_type="cpu")
    mesh = make_mesh(device_type="cpu")
    assert mesh.shape == (1, 1) and mesh.group(MODEL_AXIS) is None
    t = torch.arange(6)
    assert mesh.all_gather(t, DATA_AXIS) is t


def test_mesh_coordinates_and_slices():
    mesh = Mesh((2, 4), (1, 3))
    assert (mesh.size(DATA_AXIS), mesh.size(MODEL_AXIS)) == (2, 4)
    assert (mesh.index(DATA_AXIS), mesh.index(MODEL_AXIS)) == (1, 3)
    assert axis_slice(mesh, DATA_AXIS, 16) == slice(8, 16)
    assert axis_slice(mesh, MODEL_AXIS, 16) == slice(12, 16)
    with pytest.raises(ValueError, match="does not divide"):
        axis_slice(mesh, MODEL_AXIS, 6)
    with pytest.raises(ValueError, match="no axis"):
        mesh.size("pipe")
    with pytest.raises(RuntimeError, match="make_mesh"):
        mesh.group(MODEL_AXIS)


@pytest.mark.parametrize("bias", [True, False])
def test_gru_param_specs_match_jax(bias):
    tp = init_params(GRUConfig(V, E, U), torch.Generator().manual_seed(0), device="cpu")
    jp = jg.init_params(jg.GRUConfig(vocab_size=V, embed_dim=E, units=U), jax.random.PRNGKey(0))
    if not bias:
        tp.cell.bias = tp.dense_bias = None
        jp = dataclasses.replace(jp, cell=dataclasses.replace(jp.cell, bias=None),
                                 dense_bias=None)
    want = jsharding.gru_param_specs(jp)
    got = gru_param_specs(tp)
    pairs = [(got.embeddings, want.embeddings), (got.cell.kernel, want.cell.kernel),
             (got.cell.recurrent_kernel, want.cell.recurrent_kernel),
             (got.cell.bias, want.cell.bias), (got.dense_kernel, want.dense_kernel),
             (got.dense_bias, want.dense_bias)]
    for g, w in pairs:
        assert (g is None) == (w is None)
        if g is not None:
            assert isinstance(g, P) and tuple(g) == tuple(w), (g, w)
    assert tsharding.spec_like(tp, got).dense_kernel == P(MODEL_AXIS, None)


def _spec_leaves(tree, path=""):
    """{key path: spec} of a port spec tree (a spec is a leaf; None and the
    static fields are not)."""
    if isinstance(tree, P):
        return {path: tuple(tree)}
    out = {}
    if dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            if f.compare:
                out.update(_spec_leaves(getattr(tree, f.name), f"{path}/{f.name}".lstrip("/")))
    elif isinstance(tree, tuple):
        for i, t in enumerate(tree):
            out.update(_spec_leaves(t, f"{path}/{i}"))
    return out


@pytest.mark.parametrize("golden,qtype", [("mobilevit_tiny", None),
                                          ("mobilevit_cls_tiny", None),
                                          ("mobilevit_tiny", "q8_0")])
def test_mobilevit_param_specs_match_jax(golden, qtype):
    """The port's MobileViT spec tree equals JAX's leaf by leaf (the
    classifier row-parallel where there is one), its static fields are the
    model's, and ``place`` keeps the tree's structure, its static fields and
    its QTensor leaves on a one-rank model axis."""
    import os

    from ggml_experiments_tpu.formats import checkpoint as jckpt
    from ggml_experiments_tpu.formats.ggml_named import read_named_tensors
    from ggml_experiments_tpu.models import mobilevit as jmv
    from ggml_experiments_tpu_torch.models import mobilevit as tmv

    gold = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
    tensors = read_named_tensors(os.path.join(gold, f"{golden}.ggml"))
    kw = dict(image_size=64, neck_hidden_sizes=(8, 16, 24, 32, 40, 48, 96),
              hidden_sizes=(24, 32, 40))
    if golden == "mobilevit_cls_tiny":
        kw["num_labels"] = int(next(v.shape[-1] for k, v in tensors.items()
                                    if k.endswith("classifier/kernel:0")))
    jp = jmv.from_named_tensors(tensors, jmv.MobileViTConfig(**kw), qtype=qtype)
    tp = tmv.from_named_tensors(tensors, tmv.MobileViTConfig(**kw), qtype=qtype, device="cpu")
    jspec = jsharding.mobilevit_param_specs(jp)
    want = {jckpt._keystr(kp): tuple(leaf) for kp, leaf in jax.tree_util.tree_flatten_with_path(
        jspec, is_leaf=lambda x: isinstance(x, JP))[0]}
    got = _spec_leaves(tsharding.mobilevit_param_specs(tp))
    assert got == want
    assert (got.get("classifier_kernel") == (MODEL_AXIS, None)) == (golden != "mobilevit_tiny")
    assert got["layer_4/transformer/0/attention/wq"] == (None, MODEL_AXIS)
    assert got["layer_4/transformer/0/output_kernel"] == (MODEL_AXIS, None)
    placed = place(tp, tsharding.mobilevit_param_specs(tp), Mesh((1, 1)))
    layer = placed.layer_3.transformer[0]
    assert layer.attention.num_heads == tp.layer_3.transformer[0].attention.num_heads
    assert placed.layer_3.patch_size == tp.layer_3.patch_size
    assert placed.conv_stem.kernel is tp.conv_stem.kernel
    assert type(layer.attention.wq) is type(tp.layer_3.transformer[0].attention.wq)


def test_place_shards_float_params():
    """Each simulated rank holds 1/4 of the gate dim (JAX
    test_placed_params_shardings) and the row-parallel head's 1/4 of U; the
    shards concatenate back to the weights."""
    tp = init_params(GRUConfig(V, E, U), torch.Generator().manual_seed(0), device="cpu")
    placed = [place(tp, gru_param_specs(tp), m) for m in sim_meshes((2, 4), MODEL_AXIS)]
    k = placed[0].cell.kernel
    assert isinstance(k, tsharding.Placed) and k.spec == P(None, MODEL_AXIS)
    assert tuple(k.local.shape) == (E, 3 * U // 4) and k.shape == (E, 3 * U)
    assert placed[0].embeddings is tp.embeddings and placed[0].cell.units == U
    assert tsharding.mesh_of(placed[0]) is not None and tsharding.mesh_of(tp) is None
    for name, dim in (("kernel", 1), ("recurrent_kernel", 1), ("bias", 1)):
        whole = torch.cat([getattr(p.cell, name).local for p in placed], dim=dim)
        assert torch.equal(whole, getattr(tp.cell, name))
    head = torch.cat([p.dense_kernel.local for p in placed], dim=0)
    assert torch.equal(head, tp.dense_kernel)


def sim_sharded_qmatmul(x, jq, spec, n):
    """The port's sharded qmatmul over ``n`` simulated model ranks:
    column-parallel, each rank's local product (gate decided on the whole
    weight) concatenated along N; row-parallel, the gathered planes (the
    simulated ranks' shards in order, bit-equal to the whole weight) into
    one product. Returns (output, effective spec)."""
    qt = params_from_numpy({"embeddings": np.zeros((1, 1)), "kernel": np.zeros((1, 1)),
                            "recurrent_kernel": np.zeros((1, 1)),
                            "dense_kernel": jax_planes(jq)}, device="cpu").dense_kernel
    shards = [tsharding.qtensor_sharding(m, qt, spec) for m in sim_meshes((1, n), MODEL_AXIS)]
    eff = shards[0].spec
    xt = torch.from_numpy(x)
    if shards[0].dim == 1:
        outs = [tqm.qmatmul(xt, s.local, gate_shape=s.global_shape) for s in shards]
        return torch.cat(outs, dim=1)[:, :qt.n].numpy(), eff
    for name in PLANE_NAMES:
        if getattr(qt, name) is not None:
            whole = torch.cat([getattr(s.local, name) for s in shards], dim=0)
            assert torch.equal(whole, getattr(qt, name)), name
    return tqm.qmatmul(xt, qt).numpy(), eff


def jax_sharded_qmatmul(jmesh, x, jq, spec):
    from jax.sharding import NamedSharding

    jq_sh = jsharding.qtensor_sharding(jmesh, jq, spec)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(jmesh, JP("data")))
    return np.asarray(jquant.qmatmul(xs, jq_sh)), jq_sh.codes.sharding.spec


@pytest.mark.parametrize("qtype,k,n,spec,want_spec", [
    ("q8_0", 1024, 66, (MODEL_AXIS, None), (MODEL_AXIS, None)),    # the vocab head
    ("q4_0", 512, 128, (MODEL_AXIS, None), (MODEL_AXIS, None)),    # nibbles at Kp/2
    ("q4_k", 512, 128, (MODEL_AXIS, None), (None, MODEL_AXIS)),    # stacked supers
    ("q8_0", 32, 66, (MODEL_AXIS, None), (None, MODEL_AXIS)),      # partial blocks
    ("q8_0", 64, 192, (None, MODEL_AXIS), (None, MODEL_AXIS)),     # the gate kernels
], ids=["q8_0-row", "q4_0-row", "q4_k-sanitized", "kp-sanitized", "q8_0-col"])
def test_qtensor_sharding_matches_jax(jmesh, qtype, k, n, spec, want_spec):
    """Row-parallel honored where every shard holds whole 32-row blocks,
    sanitized to column-parallel for q4_k and an indivisible Kp, as JAX
    sanitizes; the sharded product equals JAX's sharded qmatmul."""
    rng = np.random.default_rng(k + n)
    jq = jquant.quantize((rng.standard_normal((k, n)) * 0.1).astype(np.float32), qtype)
    x = rng.standard_normal((8, k)).astype(np.float32)
    want, jspec = jax_sharded_qmatmul(jmesh, x, jq, JP(*spec))
    got, eff = sim_sharded_qmatmul(x, jq, P(*spec), 4)
    assert tuple(jspec) == tuple(eff) == want_spec
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_sharded_qmatmul_gate_is_the_global_shape(jmesh, monkeypatch):
    """A column shard of a weight past the gate (512 x 4096, K*N > 2^20)
    takes the kernel route (its plain version on the CPU) although the
    shard alone (512 x 1024) lies under it, as the JAX partitioned kernel
    decides on the global shape; equal to JAX's sharded qmatmul."""
    rng = np.random.default_rng(3)
    jq = jquant.quantize((rng.standard_normal((512, 4096)) * 0.1).astype(np.float32), "q8_0")
    x = rng.standard_normal((16, 512)).astype(np.float32)
    calls = []
    real = tqm.qmatmul_reference
    monkeypatch.setattr(tqm, "qmatmul_reference",
                        lambda x2, qt, cd: calls.append(qt.shape) or real(x2, qt, cd))
    got, eff = sim_sharded_qmatmul(x, jq, P(None, MODEL_AXIS), 4)
    assert calls == [(512, 1024)] * 4 and eff == P(None, MODEL_AXIS)
    want, _ = jax_sharded_qmatmul(jmesh, x, jq, JP(None, MODEL_AXIS))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("inner", [128, 512])
@pytest.mark.parametrize("qtype", ["q8_0", "q4_0", "dense"])
def test_auto_slot_tile_matches_jax(qtype, inner):
    for bp in range(128, 16385, 128):
        assert tf._auto_slot_tile(bp, qtype, inner) == jf._auto_slot_tile(bp, qtype, inner), bp
    assert tf.FUSED_TICK_MAX_UNTILED == jf.FUSED_TICK_MAX_UNTILED


@pytest.mark.parametrize("slot_base,key_tile", [(0, 0), (256, 0), (0, 64), (384, 128)])
def test_block_keyed_bits_match_jax_blocks(slot_base, key_tile):
    """A launch's noise, cut into blocks, is the JAX lattice of each block:
    columns within the block, keyed on the block's first global slot."""
    cols, rows, seed, j = 256, 72, 1234567, 5
    got = tf.block_keyed_bits(seed, j, rows, cols, slot_base, key_tile).numpy()
    tile = key_tile or cols
    for t0 in range(0, cols, tile):
        want = np.asarray(jf._hash_bits_u32(jnp.int32(seed), jnp.int32(j), (rows, tile),
                                            slot0=jnp.int32(slot_base + t0))).view(np.uint32)
        np.testing.assert_array_equal(got[t0:t0 + tile].astype(np.uint32), want.T)


def test_tick_shard_policy():
    assert tf.tick_shard(4000, "q8_0", 128) == tf.TickShard(0, 4000, 0,
                                                            jf._auto_slot_tile(4096, "q8_0"))
    assert tf.tick_shard(512, "q8_0", 16, 4, 2, 64) == tf.TickShard(256, 384, 256, 64)
    assert tf.tick_shard(4, "q8_0", 8, 2, 1) == tf.TickShard(4, 4, 64, 0)   # padding only
    assert tf.tick_shard(512, "q8_0", 16, 2, 0, 256) == tf.TickShard(0, 256, 0, 0)
    with pytest.raises(ValueError, match="not divisible"):
        tf.tick_shard(128, "q8_0", 16, 3, 0)
    with pytest.raises(ValueError, match="must divide"):
        tf.tick_shard(512, "q8_0", 16, 4, 0, 96)


def tick_twins():
    """JAX test_fused_slot_tick_sharded_and_tiled's 512-slot state and its
    shapes, as JAX params and as port params. The weights are drawn at the
    scale of the port's other twin tests (1/sqrt(fan-in)): the JAX test's
    unit-normal ones put a greedy near-tie (score gap 8e-5) where the port's
    128-row shard products, summed in another order than one 512-row
    product, may rightly choose apart."""
    rng = np.random.default_rng(11)
    emb = (rng.standard_normal((V, E)) * 0.5).astype(np.float32)
    cell = jg.init_params(jg.GRUConfig(vocab_size=V, embed_dim=E, units=U),
                          jax.random.PRNGKey(2)).cell

    def q(k, n, scale):
        return jquant.quantize((rng.standard_normal((k, n)) * scale).astype(np.float32), "q8_0")

    wk, wr, wd = q(E, 3 * U, E ** -0.5), q(U, 3 * U, U ** -0.5), q(U, V, 3 * U ** -0.5)
    jp = jg.GRUTextGenParams(embeddings=jnp.asarray(emb),
                             cell=dataclasses.replace(cell, kernel=wk, recurrent_kernel=wr),
                             dense_kernel=wd, dense_bias=jnp.zeros((V,), jnp.float32))
    tp = params_from_numpy({"embeddings": emb, "kernel": jax_planes(wk),
                            "recurrent_kernel": jax_planes(wr), "bias": np.asarray(cell.bias),
                            "dense_kernel": jax_planes(wd), "dense_bias": np.zeros(V)},
                           device="cpu")
    n_slots, max_prompt = 512, 8
    prompt = np.zeros((n_slots, max_prompt), np.int32)
    plen = np.zeros((n_slots,), np.int32)
    for i in range(n_slots):
        m = int(rng.integers(1, max_prompt))
        prompt[i, :m] = rng.integers(0, V, m)
        plen[i] = m
    # identical sampled prompts at the same column of every shard and tile
    prompt[::64] = prompt[0]
    plen[::64] = plen[0]
    temp = np.where(np.arange(n_slots) % 3 == 0, 0.0, 0.9).astype(np.float32)
    return jp, tp, prompt, plen, temp


def states(jp, tp, prompt, plen, temp):
    n, p = prompt.shape
    total = np.full((n,), 40, np.int32)
    js = dataclasses.replace(jengine.init_state(jp, n, p), prompt=jnp.asarray(prompt),
                             plen=jnp.asarray(plen), total=jnp.asarray(total),
                             temp=jnp.asarray(temp))
    ts = dataclasses.replace(tengine.init_state(tp, n, p), prompt=torch.from_numpy(prompt),
                             plen=torch.from_numpy(plen), total=torch.from_numpy(total),
                             temp=torch.from_numpy(temp))
    return js, ts


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_sharded_tiled_tick_matches_jax(jmesh, sampled):
    """The port's tick with its slots split over 4 simulated model ranks and
    tiled at 64 is token-equal to JAX's fused_slot_tick(mesh=, slot_axis=,
    slot_tile=64) (JAX test_fused_slot_tick_sharded_and_tiled), greedy and
    sampled: every shard and tile draws the noise JAX's block draws."""
    jp, tp, prompt, plen, temp = tick_twins()
    inner, seed = 16, 77
    js, ts = states(jp, tp, prompt, plen, temp)
    kw = dict(enable_sampling=sampled, seed=seed)
    js2, jt = jf.fused_slot_tick(jp, js, inner, compute_dtype=jnp.float32, mesh=jmesh,
                                 slot_axis="model", slot_tile=64, **kw)
    parts = [tf.fused_slot_tick_shard(tp, ts, inner, tf.tick_shard(512, "q8_0", inner, 4, r, 64),
                                      compute_dtype=torch.float32, **kw) for r in range(4)]
    h, prev, pos, toks = (torch.cat(x) for x in zip(*parts))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(prev.numpy(), np.asarray(js2.prev))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(js2.pos))
    np.testing.assert_allclose(h.numpy(), np.asarray(js2.h), atol=1e-5, rtol=1e-5)
    if sampled:
        # the identical sampled prompts of slots 64 * i draw distinct streams
        same = [tuple(toks[i].tolist()) for i in range(64, 512, 64) if temp[i] > 0]
        assert len(same) > 3 and len(set(same)) == len(same)
        # and the whole-launch keying (one block from slot 0) draws another stream
        _, whole = tf.fused_slot_tick(tp, ts, inner, compute_dtype=torch.float32,
                                      slot_tile=0, **kw)
        assert not torch.equal(whole, toks)
    else:
        _, jt0 = jf.fused_slot_tick(jp, states(jp, tp, prompt, plen, temp)[0], inner,
                                    compute_dtype=jnp.float32, slot_tile=0)
        np.testing.assert_array_equal(toks.numpy(), np.asarray(jt0))


def test_untiled_sampled_tick_keeps_its_stream():
    """Below the tiling boundary the unsharded tick is one block from slot 0:
    the keying of the parent (slot_base 0, no tiles), bit for bit."""
    _, tp, prompt, plen, temp = tick_twins()
    ts = states(*tick_twins()[:2], prompt, plen, temp)[1]
    w = tf._prep_weights(tp)
    args = (w, ts.prompt, ts.plen, ts.total, ts.prev, ts.pos, ts.h, 8, torch.float32)
    want = tf.gru_loop_reference(*args, temp=ts.temp, seed=5)
    _, got = tf.fused_slot_tick(tp, ts, 8, compute_dtype=torch.float32, enable_sampling=True,
                                seed=5)
    assert torch.equal(got, want[0].to(torch.uint8))
