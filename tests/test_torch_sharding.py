"""The port's mesh layer against the reference's on the CPU: the sharding
policy (``Sharding``, ``attention_policy``, ``moe_policy``,
``make_policy``), every spec tree (``param_specs``, ``opt_state_specs``,
``train_state_specs``, ``batch_specs``, ``cache_specs``) and the specs the
model functions constrain by (``_proj_spec``, ``_act_specs``, ``cache_spec``,
``_expert_specs``), leaf by leaf, for all ten configs at full width.

The reference runs on device-free ``AbstractMesh``es (``compat.make_abstract_mesh``)
over ``jax.eval_shape`` trees; the port on ``DeviceMesh``es of a fake
process group (``torch.testing``'s ``FakeStore`` with the ``fake`` backend,
opened and closed inside the module's fixture) over ``init_params(device="meta")``:
the production meshes 16x16 (``dp=("data",)``) and 2x16x16
(``dp=("pod", "data")``) and the 2x4 debug mesh. The reference stacks a
layer's leaves over its groups; the port's layers are unstacked, so each
port spec is the reference's without its leading ``None``.

``tests/test_torch_mesh_launch.py`` runs the launcher's ``--mesh debug``.
"""

import math
from dataclasses import asdict

import jax
import pytest
import torch
import torch.distributed as dist

from repro.compat import make_abstract_mesh
from repro.configs import ARCH_NAMES
from repro.configs import get_config as ref_get_config
from repro.models import attention as ref_attention
from repro.models import cache_specs as ref_cache_specs
from repro.models import init_decode_state as ref_init_decode_state
from repro.models import moe as ref_moe
from repro.models import param_specs as ref_param_specs
from repro.models import sharding as ref_sharding
from repro.models.config import SHAPES
from repro.optim import opt_state_specs as ref_opt_state_specs
from repro.training import init_train_state as ref_init_train_state
from repro.training.steps import batch_specs as ref_batch_specs
from repro.training.steps import train_state_specs as ref_train_state_specs
from repro_torch.launch import mesh as port_mesh
from repro_torch.models import ArchConfig, attention, init_decode_state, init_params, moe, sharding
from repro_torch.models.model import cache_specs, param_specs
from repro_torch.optim import opt_state_specs
from repro_torch.training import TrainState, batch_specs, train_state_specs

MESHES = {
    "16x16": ((16, 16), ("data", "model"), ("data",)),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model"), ("pod", "data")),
    "2x4": ((2, 4), ("data", "model"), ("data",)),
}
DECODE = SHAPES["decode_32k"]
WHAT = ("params", "opt", "train", "batch", "cache", "policy", "layer_specs")


def _tuple(tree):
    """A reference spec tree's specs as tuples."""
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


def _ref_by_name(tree: dict, cfg) -> dict:
    """The reference's per-leaf specs keyed by the port's parameter names:
    layer ``g * period + pos`` takes position ``pos``'s spec less its
    leading (groups) entry."""
    out = {}
    for key, sub in tree.items():
        if key in ("blocks", "encoder", "decoder"):
            n_layers = cfg.dec_layers if key == "decoder" else cfg.n_layers
            for layer in range(n_layers):
                for part, leaves in sub[layer % len(sub)].items():
                    for leaf, spec in leaves.items():
                        out[f"{key}.{layer}.{part}.{leaf}"] = tuple(spec)[1:]
        else:
            for leaf, spec in sub.items():
                out[f"{key}.{leaf}"] = tuple(spec)
    return out


def _ref_caches(specs: dict, cfg, n_layers: int) -> list:
    """The reference's per-position cache specs, one a layer, each less its
    leading (groups) entry."""
    caches = specs["caches"]
    return [type(c)(*(tuple(s)[1:] for s in c)) for c in
            (caches[layer % len(caches)] for layer in range(n_layers))]


def _layer_specs(mod_attention, mod_moe, sh, cfg) -> dict:
    """The specs the model functions constrain by, under ``sh`` and the
    policy's other settings."""
    out = {}
    for heads in (cfg.n_heads, cfg.n_kv_heads):
        out[f"proj_{heads}"] = tuple(mod_attention._proj_spec(sh, heads))
    out["act"] = tuple(map(tuple, mod_attention._act_specs(sh, cfg)))
    for cache in ("seq", "heads"):
        out[f"cache_{cache}"] = tuple(mod_attention.cache_spec(
            cfg, type(sh)(**{**sh.__dict__, "decode_cache": cache})))
    for policy in ("expert", "ffn"):
        out[f"experts_{policy}"] = tuple(map(tuple, mod_moe._expert_specs(
            type(sh)(**{**sh.__dict__, "moe": policy}))))
    return out


@pytest.fixture(scope="module")
def ref():
    out = {}
    for name in ARCH_NAMES:
        cfg = ref_get_config(name)
        state = jax.eval_shape(lambda: ref_init_train_state(jax.random.PRNGKey(0), cfg))
        dstate = jax.eval_shape(lambda: ref_init_decode_state(state.params, cfg,
                                                              DECODE.global_batch, DECODE.seq_len))
        n_dec = cfg.dec_layers if cfg.is_encdec else cfg.n_layers
        for mesh_name, (shape, names, dp) in MESHES.items():
            sh = ref_sharding.make_policy(cfg, make_abstract_mesh(shape, names), dp=dp)
            pspecs = ref_param_specs(state.params, cfg, sh)
            opt = ref_opt_state_specs(pspecs)
            train = ref_train_state_specs(state, cfg, sh)
            out[mesh_name, name] = {
                "params": _ref_by_name(pspecs, cfg),
                "opt": (tuple(opt.step), _ref_by_name(opt.m, cfg), _ref_by_name(opt.v, cfg),
                        opt.master),
                "train": (_ref_by_name(train.params, cfg), tuple(train.step)),
                "batch": _tuple(ref_batch_specs(cfg, sh)),
                "cache": _ref_caches(ref_cache_specs(dstate, cfg, sh), cfg, n_dec),
                "policy": (sh.attn, sh.moe, sh.sp_activations),
                "layer_specs": _layer_specs(ref_attention, ref_moe, sh, cfg),
            }
    return out


@pytest.fixture(scope="module")
def port():
    """The port's specs on each mesh, each mesh on a fake process group of
    its size, opened and closed here."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    models = {}
    for name in ARCH_NAMES:
        cfg = ArchConfig(**asdict(ref_get_config(name)))
        params = init_params(cfg, generator=torch.Generator(), device="meta")
        models[name] = (cfg, params, init_decode_state(params, cfg, DECODE.global_batch,
                                                       DECODE.seq_len))
    out = {}
    for mesh_name, (shape, names, dp) in MESHES.items():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=math.prod(shape))
        try:
            mesh = (port_mesh.make_debug_mesh(*shape, device_type="cpu") if mesh_name == "2x4"
                    else port_mesh.make_production_mesh(multi_pod=len(shape) == 3,
                                                        device_type="cpu"))
            for name, (cfg, params, dstate) in models.items():
                sh = sharding.make_policy(cfg, mesh, dp=dp)
                pspecs = param_specs(params, cfg, sh)
                opt = opt_state_specs(pspecs)
                train = train_state_specs(TrainState(params, None, None), cfg, sh)
                out[mesh_name, name] = {
                    "params": pspecs,
                    "opt": (opt.step, opt.m, opt.v, opt.master),
                    "train": (train.params, train.step),
                    "batch": batch_specs(cfg, sh),
                    "cache": cache_specs(dstate, cfg, sh)["caches"],
                    "policy": (sh.attn, sh.moe, sh.sp_activations),
                    "layer_specs": _layer_specs(attention, moe, sh, cfg),
                }
        finally:
            dist.destroy_process_group()
    return out


@pytest.mark.parametrize("what", WHAT)
@pytest.mark.parametrize("name", ARCH_NAMES)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_spec_trees_match_the_reference(ref, port, mesh_name, name, what):
    assert port[mesh_name, name][what] == ref[mesh_name, name][what]


def test_the_param_specs_cover_every_parameter(port):
    for (mesh_name, name), got in port.items():
        assert len(got["params"]) > 0
        assert got["opt"][1] == got["opt"][2] == got["params"] and got["opt"][3] is None


def test_specs_without_a_mesh_are_empty():
    cfg = ArchConfig(**asdict(ref_get_config("qwen2-1.5b")))
    params = init_params(cfg, generator=torch.Generator(), device="meta")
    assert set(param_specs(params, cfg, sharding.NULL).values()) == {()}
    state = init_decode_state(params, cfg, 2, 8)
    assert all(c == type(c)((), (), ()) for c in cache_specs(state, cfg, sharding.NULL)["caches"])
    assert sharding.make_policy(cfg, None) is sharding.NULL


@pytest.mark.parametrize("tp", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_attention_and_moe_policies_match_the_reference(name, tp):
    ref_cfg = ref_get_config(name)
    cfg = ArchConfig(**asdict(ref_cfg))
    assert sharding.attention_policy(cfg, tp) == ref_sharding.attention_policy(ref_cfg, tp)
    assert sharding.moe_policy(cfg, tp) == ref_sharding.moe_policy(ref_cfg, tp)


@pytest.fixture
def fake_16x16():
    """A 16x16 mesh of a fake process group and the reference's abstract
    one, for the checks that need only the mesh's shape."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
    try:
        mesh = port_mesh.make_production_mesh(device_type="cpu")
        yield mesh, make_abstract_mesh((16, 16), ("data", "model"))
    finally:
        dist.destroy_process_group()


WHISPER_DIMS = [(384, ("data", "model")), (384, "model"), (384, "data"), (1536, ("data", "model")),
                (6, "model"), (51968, "model"), (64, ("data", "model")), (4096, ("data", "model"))]


@pytest.mark.parametrize("size,part", WHISPER_DIMS)
def test_fit_spec_backs_off_as_the_reference(fake_16x16, size, part):
    mesh, abstract = fake_16x16
    spec = (part, None)
    want = tuple(ref_sharding.Sharding(mesh=abstract).fit_spec((size, 8), jax.sharding.PartitionSpec(
        *spec)))
    assert sharding.Sharding(mesh=mesh).fit_spec((size, 8), spec) == want


def test_placements_of_a_spec(fake_16x16):
    from torch.distributed.tensor import Replicate, Shard

    sh = sharding.Sharding(mesh=fake_16x16[0])
    assert sh.named("dp", "tp") == (Shard(0), Shard(1))
    assert sh.named(None, ("fsdp", "tp")) == (Shard(1), Shard(1))
    assert sh.named("tp", None) == (Replicate(), Shard(0))
    assert sh.named(None, None) == (Replicate(), Replicate())
    assert (sh.tp_size, sh.dp_size) == (16, 16)
    with pytest.raises(ValueError, match="out of the mesh's order"):
        sh.placements((("model", "data"),))
    assert sharding.NULL.named("dp") is None


def test_constrain_without_a_mesh_is_the_same_object():
    x = torch.ones(3, 4)
    assert sharding.NULL.constrain(x, "dp", "tp") is x
    assert sharding.NULL.fit_spec((3, 4), ("data", "model")) == ("data", "model")
    with pytest.raises(ValueError, match="unknown logical axis"):
        sharding.NULL.spec("bogus")


def test_a_mesh_of_another_size_than_the_group_raises(fake_16x16):
    with pytest.raises(ValueError, match=r"needs 8 ranks; the process group has 256"):
        port_mesh.make_debug_mesh(device_type="cpu")
    with pytest.raises(ValueError, match=r"needs 512 ranks; the process group has 256"):
        port_mesh.make_production_mesh(multi_pod=True, device_type="cpu")
    assert port_mesh.dp_axes(True) == ("pod", "data") and port_mesh.dp_axes() == ("data",)


def test_a_mesh_without_a_group_raises():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="none is initialized"):
        port_mesh.make_debug_mesh(device_type="cpu")
