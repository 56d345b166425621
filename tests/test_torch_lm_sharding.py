"""The LM half of ``distributed/sharding.py`` and its pure helpers on the
port, against the JAX package: ``sharding_profile``, ``make_rules``,
``logical_to_pspec`` (against ``PartitionSpec``), ``pad_vocab``,
``choose_microbatches``, ``choose_remat_group`` and
``adjust_batch_schedule`` for every arch (full and reduced) x applicable
shape x mesh (the two production meshes and the (2, 2), (1, 4) and
(4, 1) meshes of the process worlds), ``Model.specs()`` and
``make_train_state_specs`` for every family, and every case of
``tests/test_sharding.py`` but the ``moe_shard_map`` one, which
``tests/test_torch_lm_parallel.py``'s worlds cover. No device state is
touched: the rules are pure functions of the configs.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import applicable_shapes as j_applicable_shapes
from repro.configs import reduced as j_reduced
from repro.configs.base import MeshConfig as JMeshConfig
from repro.distributed import sharding as jshd
from repro.models.model import build_model as j_build_model
from repro.train import elastic as j_elastic
from repro.train import train_step as j_train_step
from repro_torch.configs import ARCHS, applicable_shapes, reduced, \
    skipped_cells
from repro_torch.configs.base import MULTI_POD_MESH, SINGLE_POD_MESH, \
    MeshConfig
from repro_torch.distributed import sharding as shd
from repro_torch.models.model import build_model
from repro_torch.train import elastic
from repro_torch.train import train_step as ts

MESHES = {"single": SINGLE_POD_MESH, "multi": MULTI_POD_MESH,
          "2x2": MeshConfig((2, 2), ("data", "model")),
          "1x4": MeshConfig((1, 4), ("data", "model")),
          "4x1": MeshConfig((4, 1), ("data", "model"))}
CASES = [(arch, shape.name, mesh) for arch in sorted(ARCHS)
         for shape in applicable_shapes(ARCHS[arch]) for mesh in MESHES]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch while a test runs: the suite's
    workers share the cores, and torch's own threads would oversubscribe
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch, size):
    cfg, jcfg = ARCHS[arch], J_ARCHS[arch]
    if size == "reduced":
        cfg, jcfg = reduced(cfg), j_reduced(jcfg)
    return cfg, jcfg


@functools.lru_cache(maxsize=None)
def _logical_axes(arch, size):
    """Every logical tuple of the arch's parameters, and the activations'
    of the model code."""
    cfg, _ = _pair(arch, size)
    specs = set(build_model(cfg, device="cpu").specs().values())
    return sorted(specs | {
        (shd.BATCH, None), (shd.BATCH, None, None),
        (shd.BATCH, None, shd.HEADS, None),
        (shd.BATCH, None, shd.KV_HEADS, None),
        (shd.BATCH, None, shd.MLP), (shd.BATCH, None, shd.VOCAB),
        (shd.BATCH, shd.KV_SEQ, shd.KV_HEADS, None),
        (shd.LAYERS, shd.BATCH, shd.KV_SEQ, shd.KV_HEADS),
        (shd.BATCH, None, shd.SSD_HEADS, None)}, key=repr)


def _norm(pspec):
    """A pspec with each one-axis tuple as its axis: ``PartitionSpec``
    takes ``("data",)`` and ``"data"`` for one layout."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in pspec)


def _shape_of(cfg, name):
    return next(s for s in applicable_shapes(cfg) if s.name == name)


@pytest.mark.parametrize("arch,shape,mesh", CASES)
def test_rules_match_jax(arch, shape, mesh):
    """The profile, the rule table, every logical tuple's pspec, the
    micro-batch depth and the remat group of one (arch, shape, mesh)
    cell, and ``pad_vocab`` of its vocabulary, equal JAX's, for the
    arch's full config and its reduced one."""
    for size in ("full", "reduced"):
        _rules_match(arch, size, shape, mesh)


def _rules_match(arch, size, shape, mesh):
    cfg, jcfg = _pair(arch, size)
    cell = _shape_of(cfg, shape)
    jcell = next(s for s in j_applicable_shapes(J_ARCHS[arch])
                 if s.name == shape)
    mcfg = MESHES[mesh]
    jm = JMeshConfig(mcfg.shape, mcfg.axes)
    args = (cell.global_batch, cell.seq_len, cell.kind)
    jargs = (jcell.global_batch, jcell.seq_len, jcell.kind)
    prof = shd.sharding_profile(cfg, mcfg, *args)
    jprof = jshd.sharding_profile(jcfg, jm, *jargs)
    assert dataclasses.asdict(prof) == dataclasses.asdict(jprof)
    rules = shd.make_rules(cfg, mcfg, *args)
    assert rules == jshd.make_rules(jcfg, jm, *jargs)
    for logical in _logical_axes(arch, size):
        want = jshd.logical_to_pspec(logical, rules)
        assert _norm(shd.logical_to_pspec(logical, rules)) == \
            _norm(tuple(want)), logical
    assert shd.pad_vocab(cfg.vocab_size) == jshd.pad_vocab(cfg.vocab_size)
    if cell.kind == "train":
        mu = ts.choose_microbatches(cfg, cell, mcfg, prof)
        assert mu == j_train_step.choose_microbatches(jcfg, jcell, jm,
                                                      jprof)
        for m in {mu, 1, 2}:
            assert ts.choose_remat_group(cfg, cell, mcfg, prof, m) == \
                j_train_step.choose_remat_group(jcfg, jcell, jm, jprof, m)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_specs_match_jax(arch):
    """``Model.specs()`` names every parameter of ``init`` and equals the
    JAX ``specs()`` under ``convert.py``'s naming (the stacked leaves'
    leading ``layers`` axis dropped); ``make_train_state_specs`` carries
    them into the moments."""
    from repro_torch import convert
    cfg, jcfg = _pair(arch, "reduced")
    model = build_model(cfg, device="cpu")
    specs = model.specs()
    assert set(specs) == set(model.init(torch.Generator().manual_seed(0)))
    jspecs = j_build_model(jcfg).specs()

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}{k}/"))
            else:
                out[f"{prefix}{k}"] = v
        return out

    jflat = flat(jspecs)
    for name, spec in specs.items():
        key, layer = convert._jax_key(name)
        want = jflat[key]
        if layer is not None:
            assert want[0] == jshd.LAYERS, key
            want = want[1:]
        assert spec == want, name
    assert {convert._jax_key(n)[0] for n in specs} == set(jflat)
    state = ts.make_train_state_specs(model)
    jstate = j_train_step.make_train_state_specs(j_build_model(jcfg))
    assert state.params == specs
    assert state.opt["m"] == state.opt["v"] == specs
    assert state.opt["step"] == jstate.opt["step"] == ()


@pytest.mark.parametrize("mesh", ["2x2", "1x4", "4x1"])
def test_state_shardings_match_jax(mesh):
    """``elastic.state_shardings`` places every leaf of the reduced
    starcoder2-7b's train state by the pspec JAX's ``state_shardings``
    gives it."""
    import jax
    from repro_torch import convert
    cfg, jcfg = _pair("starcoder2-7b", "reduced")
    mcfg = MESHES[mesh]
    model = build_model(cfg, device="cpu")
    places = elastic.state_shardings(model, "mesh", mcfg, 8)
    jm = jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                           ("data", "model"))
    jplaces = j_elastic.state_shardings(
        j_build_model(jcfg), jm, JMeshConfig(mcfg.shape, mcfg.axes), 8)
    jparams = jax.tree.map(lambda s: _norm(tuple(s.spec)), jplaces.params)
    for name, p in places.params.items():
        key, layer = convert._jax_key(name)
        node = jparams
        for part in key.split("/"):
            node = node[part]
        want = node[1:] if layer is not None else node
        want = tuple(want) + (None,) * 4
        assert p.mesh == "mesh"
        assert _norm(p.pspec) == want[:len(p.pspec)], name
        assert all(x is None for x in want[len(p.pspec):]), name
    assert places.opt["m"] == places.opt["v"] == places.params
    assert places.opt["step"].pspec == ()


@pytest.mark.parametrize("b,old,new,step", [(256, 16, 8, 100),
                                            (256, 16, 32, 7), (8, 2, 4, 0),
                                            (6, 2, 4, 3)])
def test_adjust_batch_schedule_matches_jax(b, old, new, step):
    if b % new:
        with pytest.raises(ValueError):
            elastic.adjust_batch_schedule(b, old, new, step)
        with pytest.raises(ValueError):
            j_elastic.adjust_batch_schedule(b, old, new, step)
        return
    assert elastic.adjust_batch_schedule(b, old, new, step) == \
        j_elastic.adjust_batch_schedule(b, old, new, step)


# ------------------------------------------ tests/test_sharding.py's cases
@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("mesh", [SINGLE_POD_MESH, MULTI_POD_MESH],
                         ids=["single", "multi"])
def test_profiles_well_formed(arch, mesh):
    cfg = ARCHS[arch]
    for shape in applicable_shapes(cfg):
        prof = shd.sharding_profile(cfg, mesh, shape.global_batch,
                                    shape.seq_len, shape.kind)
        model_axis = dict(zip(mesh.axes, mesh.shape)).get("model", 1)
        if prof.attn_tp:
            assert cfg.num_heads % model_axis == 0
            stored = cfg.num_kv_heads * prof.kv_repeat
            if shape.kind != "decode":
                assert stored % model_axis == 0
        if prof.mlp_tp:
            assert cfg.d_ff % model_axis == 0
        if prof.expert_tp:
            assert cfg.moe.num_experts % model_axis == 0
        n = 1
        for ax in prof.batch_axes:
            n *= dict(zip(mesh.axes, mesh.shape))[ax]
        if prof.batch_axes:
            assert shape.global_batch % n == 0
        if shape.kind == "decode" and prof.kv_seq_shard:
            assert shape.seq_len % model_axis == 0


def test_known_fallbacks():
    """hymba (25H) and starcoder2 (36H) can't head-TP on a 16-wide axis."""
    for arch in ("hymba-1.5b", "starcoder2-7b"):
        prof = shd.sharding_profile(ARCHS[arch], SINGLE_POD_MESH, 256,
                                    4096, "train")
        assert not prof.attn_tp
        assert prof.mlp_tp               # TP-MLP hybrid fallback
    prof = shd.sharding_profile(ARCHS["granite-34b"], SINGLE_POD_MESH, 256,
                                4096, "train")
    assert prof.attn_tp and prof.kv_repeat == 16     # MQA: 1 -> 16


def test_decode_uses_seq_sharding_not_repeat():
    prof = shd.sharding_profile(ARCHS["mistral-large-123b"],
                                SINGLE_POD_MESH, 128, 32768, "decode")
    assert prof.kv_seq_shard and prof.kv_repeat == 1


def test_logical_to_pspec_trims_trailing_nones():
    rules = {"batch": ("data",), "mlp": "model"}
    assert shd.logical_to_pspec(("batch", None, "mlp"), rules) == \
        (("data",), None, "model")
    assert shd.logical_to_pspec(("batch", None, None), rules) == \
        (("data",),)


def test_skip_list_is_exactly_full_attention_long_500k():
    skips = skipped_cells()
    assert all(s[1] == "long_500k" for s in skips)
    skipped_archs = {s[0] for s in skips}
    assert "mamba2-780m" not in skipped_archs
    assert "hymba-1.5b" not in skipped_archs
    assert len(skips) == 8


def test_vocab_padding():
    assert shd.pad_vocab(50280) % 256 == 0
    assert shd.pad_vocab(50280) >= 50280
    assert shd.pad_vocab(256) == 256


def test_cell_count_is_32():
    from repro_torch.configs import all_cells
    assert len(all_cells()) == 32


def test_kv_repeat_preserves_attention_semantics():
    """Repeating stored KV heads for TP divisibility must not change the
    attention output (group mapping stays aligned)."""
    from repro_torch.kernels import ops
    from repro_torch.models.attention import _repeat_kv
    rng = np.random.default_rng(0)
    q = torch.tensor(rng.normal(size=(2, 64, 8, 32)), dtype=torch.float32)
    k = torch.tensor(rng.normal(size=(2, 64, 2, 32)), dtype=torch.float32)
    v = torch.tensor(rng.normal(size=(2, 64, 2, 32)), dtype=torch.float32)
    base = ops.flash_attention_vjp(q, k, v, causal=True)
    rep = ops.flash_attention_vjp(q, _repeat_kv(k, 2), _repeat_kv(v, 2),
                                  causal=True)
    np.testing.assert_allclose(base.numpy(), rep.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_constrain_checks_the_local_shape():
    """Without a mesh ``constrain`` returns its input; under one it holds
    the local dim to the rule's shard of the full size and raises where it
    is not (a stand-in mesh: the check reads only sizes)."""
    class Sizes:
        world = 4
        axes = ("data", "model")

        def size(self, ax):
            return 2

    x = torch.zeros(2, 8, 3, 16)
    assert shd.constrain(x, shd.BATCH, None, shd.HEADS, None) is x
    rules = {shd.BATCH: ("data",), shd.HEADS: "model"}
    with shd.use_ctx(shd.ShardCtx(Sizes(), rules)):
        assert shd.constrain(x, shd.BATCH, None, shd.HEADS, None,
                             full=(4, 8, 6, 16)) is x
        with pytest.raises(ValueError):
            shd.constrain(x, shd.BATCH, None, shd.HEADS, None,
                          full=(4, 8, 3, 16))
        with pytest.raises(ValueError):
            shd.constrain(x, shd.BATCH, None, shd.HEADS)
    assert shd.current_ctx() is None


def test_production_mesh_needs_its_world():
    """``mesh_config`` names JAX's production meshes; building one needs
    a world of 256 (or 512) ranks, and a world of one raises."""
    from repro.launch import mesh as jmesh
    from repro_torch.launch import mesh
    for multi in (False, True):
        got, want = mesh.mesh_config(multi_pod=multi), \
            jmesh.mesh_config(multi_pod=multi)
        assert (got.shape, got.axes) == (want.shape, want.axes)
        with pytest.raises(RuntimeError, match="ranks"):
            mesh.make_production_mesh(multi_pod=multi, device="cpu")
    one = mesh.make_mesh_from_config(MeshConfig((1, 1), ("data", "model")),
                                     "cpu")
    assert (one.world, one.rank, one.coords) == (1, 0, (0, 0))
