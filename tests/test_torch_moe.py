"""The port's MoE FFN (``repro_torch.models.moe``) and the three models that
use it (``olmoe-1b-7b``, ``granite-moe-3b-a800m``, the hybrid
``jamba-v0.1-52b``) against the reference's ``repro.models`` on the CPU.

Both packages compute on the same weights: the reference draws them,
``convert.tensor_from_numpy`` and ``convert.lm_from_numpy`` carry them
across. Inputs are made with numpy from a seed.

A top-k router turns a small difference in its input into a different
choice of experts when two probabilities are nearly tied, and then the
outputs differ by O(1). So every comparison here is made where the routing
cannot differ, and says why:

- the MoE layer gets bit-identical inputs on both sides, and the port's
  choice must equal the reference's, with the smallest gap between the k-th
  and (k+1)-th probability asserted above ``LAYER_MARGIN`` (1e-5: the two
  routers' fp32 sums differ by about 1e-7). Then y within 1e-5 (fp32) or
  2e-2 (bf16) of max |ref|, the aux loss within 1e-6, equal drop counts;
- the whole model in fp32, where the hidden states reaching a router differ
  between the packages by about 1e-6: the port's smallest margin over the
  run is asserted at or above ``MODEL_MARGIN`` (1e-4) as the comparison's
  precondition; logits and the aux loss within 1e-4;
- in bf16 the hidden states differ by a bf16 rounding (4e-3), more than a
  margin can be asserted against, so there is no whole-model comparison:
  each layer gets the same bf16 input on both sides (the reference's output
  of the layer before) and is held to 5e-2, as the port's other bf16
  layers are.
"""

from contextlib import contextmanager
from dataclasses import asdict, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke as ref_get_smoke
from repro.models import blocks as ref_blocks
from repro.models import decode_step as ref_decode_step
from repro.models import forward as ref_forward
from repro.models import init_decode_state as ref_init_decode_state
from repro.models import init_params as ref_init_params
from repro.models import moe as ref_moe
from repro_torch import configs, convert
from repro_torch.models import (
    ArchConfig,
    blocks,
    decode_step,
    forward,
    init_decode_state,
    init_params,
    moe,
)

NAMES = ("olmoe-1b-7b", "granite-moe-3b-a800m", "jamba-v0.1-52b")
LAYER_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
AUX_TOL = 1e-6
LAYER_MARGIN = 1e-5
MODEL_TOL = 1e-4
MODEL_MARGIN = 1e-4
BF16_LAYER_TOL = 5e-2
B, S, STEPS = 2, 16, 16
#: The tokens' seed. At seed 5 (the dense decoders' tests') jamba's second
#: MoE layer reads a margin of 2.4e-6, which the fp32 comparison's
#: precondition refuses; at 6 the three models' smallest margins are 5.3e-4
#: and above.
TOKEN_SEED = 6
#: Tokens of the MoE layer's cases: 320 in the plain cases; 640 in the
#: skewed one, where nearly every token chooses expert 0, more than its
#: queue of 256 (8 experts) or 512 (4 or 5) slots holds.
TOKENS, SKEW_TOKENS = 320, 640


def _rel(got: torch.Tensor, want) -> float:
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def _port_cfg(ref_cfg) -> ArchConfig:
    return ArchConfig(**asdict(ref_cfg))


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


# --------------------------------------------------------------------------
# the reference's routing, as apply_moe computes it inline
# --------------------------------------------------------------------------

def _ref_ids(xf, router, k):
    """``repro/models/moe.py:58-60``: the router's top-k experts."""
    probs = jax.nn.softmax(jnp.asarray(xf).astype(jnp.float32) @ jnp.asarray(router), axis=-1)
    return np.asarray(jax.lax.top_k(probs, k)[1])


def _ref_capacity(t, k, e, capacity_factor=1.25):
    """``repro/models/moe.py:78``."""
    return max((int(t * k * capacity_factor / e) + 255) // 256 * 256, 256)


def _ref_positions(ids, e, cap):
    """``repro/models/moe.py:79-83``: each choice's place in its expert's
    queue (token-major) and whether it is kept."""
    flat_expert = jnp.asarray(ids).reshape(-1)
    onehot = jax.nn.one_hot(flat_expert, e, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=0) - onehot) * onehot, axis=-1)
    return np.asarray(pos).reshape(ids.shape), np.asarray(pos < cap).reshape(ids.shape)


# --------------------------------------------------------------------------
# (i) the MoE layer on bit-identical inputs
# --------------------------------------------------------------------------

def _layer_case(name, dtype, case):
    """The reference's MoE weights for ``name``'s smoke config (``act``
    overridden in the activation cases), the port's copy, and x (1, T, D)
    from numpy in ``dtype``; in the skewed case the router's column 0 is
    raised by 0.1 and x's mean by 0.5 (expert 0's logit by about 3), so
    nearly every token chooses expert 0 and its queue overflows."""
    ref_cfg = replace(ref_get_smoke(name), dtype=dtype)
    if case in ("sq_relu", "gelu"):
        ref_cfg = replace(ref_cfg, act=case)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    p = ref_moe.init_moe(jax.random.PRNGKey(7), ref_cfg, jdt)
    rng = np.random.default_rng(11)
    t = SKEW_TOKENS if case == "skewed" else TOKENS
    x = rng.standard_normal((1, t, ref_cfg.d_model), dtype=np.float32)
    if case == "skewed":
        p["router"] = p["router"].at[:, 0].add(0.1)
        x += 0.5
    x = jnp.asarray(x, jdt)
    port = moe.MoE({k: convert.tensor_from_numpy(v, "cpu") for k, v in _numpy(p).items()})
    return ref_cfg, p, x, port, convert.tensor_from_numpy(np.asarray(x), "cpu")


@pytest.mark.parametrize("case", ["own_act", "sq_relu", "gelu", "skewed"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", NAMES)
def test_apply_moe_matches_the_reference(name, dtype, case):
    ref_cfg, p, x, port, xt = _layer_case(name, dtype, case)
    cfg = _port_cfg(ref_cfg)
    t, e, k = x.shape[1], cfg.n_experts, cfg.top_k
    assert port.router.dtype == torch.float32 and port.wi.dtype == xt.dtype
    assert ("wg" in port) == (cfg.act == "silu_glu")
    # the choice first: equal experts, far enough from a tie to be a fact
    r = moe.route(port, xt.reshape(t, -1), k)
    assert float(moe.router_margin(r)) > LAYER_MARGIN
    ref_ids = _ref_ids(np.asarray(x).reshape(t, -1), p["router"], k)
    assert np.array_equal(r.ids.numpy(), ref_ids)
    cap = moe.capacity(t, k, e)
    _, keep = moe.assign(r.ids, e, cap)
    _, ref_keep = _ref_positions(ref_ids, e, _ref_capacity(t, k, e))
    assert int((~keep).sum()) == int((~ref_keep).sum())
    counts = torch.bincount(r.ids.reshape(-1), minlength=e)
    assert int((~keep).sum()) == int((counts - cap).clamp_min(0).sum())
    if case == "skewed":
        assert int(counts[0]) > cap  # expert 0's queue overflows
    y, aux = moe.apply_moe(port, xt, cfg)
    ref_y, ref_aux = ref_moe.apply_moe(p, x, ref_cfg)
    assert y.dtype == xt.dtype and y.shape == xt.shape
    assert _rel(y, np.asarray(ref_y, np.float32)) <= LAYER_TOL[dtype]
    assert abs(float(aux) - float(ref_aux)) <= AUX_TOL


def test_apply_moe_takes_a_fixed_routing():
    """Given a routing, apply_moe follows it, whatever its router says."""
    ref_cfg, p, x, port, xt = _layer_case("olmoe-1b-7b", "float32", "own_act")
    cfg = _port_cfg(ref_cfg)
    xf = xt.reshape(-1, cfg.d_model)
    r = moe.route(port, xf, cfg.top_k)
    shuffled = moe.Routing(r.probs, r.gates, torch.roll(r.ids, 1, dims=1))
    y, _ = moe.apply_moe(port, xt, cfg)
    assert torch.equal(moe.apply_moe(port, xt, cfg, routing=r)[0], y)
    assert _rel(moe.apply_moe(port, xt, cfg, routing=shuffled)[0], y.numpy()) > 1e-2


# --------------------------------------------------------------------------
# (ii) capacity and queue positions
# --------------------------------------------------------------------------

TRIPLES = [(1, 8, 40), (1, 2, 16), (2, 8, 64), (7, 2, 5), (205, 8, 40), (2048, 8, 40),
           (2048, 8, 64), (2048, 2, 16), (4096, 2, 16), (333, 2, 4)]


@pytest.mark.parametrize("t,k,e", TRIPLES)
def test_capacity_and_positions_match_the_reference(t, k, e):
    for cf in (1.0, 1.25, 2.0):
        assert moe.capacity(t, k, e, cf) == _ref_capacity(t, k, e, cf)
    rng = np.random.default_rng(t * 1000 + k * 100 + e)
    # distinct experts a token, skewed towards the low ids so queues overflow
    weights = np.exp(-np.arange(e) / max(e / 8, 1.0))
    ids = np.stack([rng.choice(e, k, replace=False, p=weights / weights.sum())
                    for _ in range(t)]).astype(np.int64)
    for cap in (moe.capacity(t, k, e), 1, 3, max(t // 4, 1)):
        pos, keep = moe.assign(torch.from_numpy(ids), e, cap)
        ref_pos, ref_keep = _ref_positions(ids, e, cap)
        assert np.array_equal(pos.numpy(), ref_pos)
        assert np.array_equal(keep.numpy(), ref_keep)


def test_dispatch_and_combine_move_each_kept_choice_once():
    """Every kept choice's token lands in its own slot; combining the
    buffer itself (experts as the identity) gives back each token times its
    kept gates' sum."""
    rng = np.random.default_rng(3)
    t, k, e, d = 300, 2, 4, 8
    probs = torch.softmax(torch.from_numpy(rng.standard_normal((t, e))).float() * 3, -1)
    gates, ids = torch.topk(probs, k)
    r = moe.Routing(probs, gates / gates.sum(-1, keepdim=True), ids)
    cap = 128
    pos, keep = moe.assign(ids, e, cap)
    assert bool((~keep).any())
    xf = torch.from_numpy(rng.standard_normal((t, d))).float()
    xe = moe.dispatch(xf, ids, pos, keep, e, cap)
    filled = xe.abs().sum(-1) > 0
    assert int(filled.sum()) == int(keep.sum())
    for tok, j in zip(*np.nonzero(keep.numpy())):
        assert torch.equal(xe[ids[tok, j], pos[tok, j]], xf[tok])
    want = xf * (r.gates * keep).sum(-1, keepdim=True)
    assert torch.allclose(moe.combine(xe, r, pos, keep), want, atol=1e-6)


# --------------------------------------------------------------------------
# (iii) the whole model in fp32
# --------------------------------------------------------------------------

@contextmanager
def _margins():
    """Every ``apply_moe`` call of the port's layers, watched: the list
    receives each call's :func:`moe.routing_stats`."""
    seen = []
    real = blocks.apply_moe

    def watched(p, x, cfg, *args, **kw):
        seen.append(moe.routing_stats(p, x, cfg))
        return real(p, x, cfg, *args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(blocks, "apply_moe", watched)
        yield seen


@pytest.fixture(scope="module", params=NAMES)
def run(request):
    name = request.param
    ref_cfg = replace(ref_get_smoke(name), dtype="float32")
    cfg = _port_cfg(ref_cfg)
    params = ref_init_params(jax.random.PRNGKey(3), ref_cfg)
    model = convert.lm_from_numpy(_numpy(params), cfg, device="cpu")
    tokens = np.random.default_rng(TOKEN_SEED).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    fwd = jax.jit(ref_forward, static_argnums=1, static_argnames=("mode",))
    ref = {mode: fwd(params, ref_cfg, {"tokens": jnp.asarray(tokens)}, mode=mode)
           for mode in ("train", "prefill")}
    state = ref_init_decode_state(params, ref_cfg, B, S)
    step = jax.jit(ref_decode_step, static_argnums=1)
    ref_steps = []
    for t in range(STEPS):
        lg, state = step(params, ref_cfg, state, jnp.asarray(tokens[:, t:t + 1]))
        ref_steps.append(np.asarray(lg, np.float32))
    tok = torch.from_numpy(tokens).long()
    with _margins() as seen:
        got = {mode: forward(model, cfg, {"tokens": tok}, mode=mode)
               for mode in ("train", "prefill")}
        pstate = init_decode_state(model, cfg, B, S)
        steps = []
        for t in range(STEPS):
            lg, pstate = decode_step(model, cfg, pstate, tok[:, t:t + 1])
            steps.append(lg)
    return {"name": name, "cfg": cfg, "model": model,
            "ref": {m: (np.asarray(lg, np.float32), float(aux)) for m, (lg, aux) in ref.items()},
            "ref_steps": ref_steps, "got": got, "steps": steps,
            "margin": min(float(m) for _, m in seen), "moe_calls": len(seen)}


def _precondition(run):
    assert run["margin"] >= MODEL_MARGIN, (
        f"{run['name']}: the router's smallest margin {run['margin']:.2e} is below "
        f"{MODEL_MARGIN}: a difference of 1e-6 could change a choice")


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_forward_matches_the_reference(run, mode):
    _precondition(run)
    cfg = run["cfg"]
    v = cfg.vocab_size
    got, aux = run["got"][mode]
    want, want_aux = run["ref"][mode]
    assert got.shape == (B, S, cfg.padded_vocab)
    assert _rel(got[..., :v], want[..., :v]) <= MODEL_TOL
    assert abs(float(aux) - want_aux) <= MODEL_TOL * max(abs(want_aux), 1.0)
    assert float(aux) > 0


def test_decode_steps_match_the_reference(run):
    _precondition(run)
    v = run["cfg"].vocab_size
    n_moe = sum(blocks.layer_kind(run["cfg"], layer)[1] == "moe"
                for layer in range(run["cfg"].n_layers))
    assert run["moe_calls"] == n_moe * (2 + STEPS)
    for got, want in zip(run["steps"], run["ref_steps"]):
        assert got.shape == (B, 1, run["cfg"].padded_vocab)
        assert _rel(got[..., :v], want[..., :v]) <= MODEL_TOL


def test_converted_moe_leaves_are_the_reference_leaves(run):
    cfg, model = run["cfg"], run["model"]
    for layer, p in enumerate(model.blocks):
        assert p.ffn == blocks.layer_kind(cfg, layer)[1]
        if p.moe is not None:
            assert p.moe.router.shape == (cfg.d_model, cfg.n_experts)
            assert p.moe.wi.shape == (cfg.n_experts, cfg.d_model, cfg.moe_d_ff)
            assert p.moe.wo.shape == (cfg.n_experts, cfg.moe_d_ff, cfg.d_model)


# --------------------------------------------------------------------------
# (iv) bf16, layer by layer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_bf16_layers_match_the_reference(name):
    ref_cfg = replace(ref_get_smoke(name), dtype="bfloat16")
    cfg = _port_cfg(ref_cfg)
    params = ref_init_params(jax.random.PRNGKey(3), ref_cfg)
    model = convert.lm_from_numpy(_numpy(params), cfg, device="cpu")
    tokens = np.random.default_rng(TOKEN_SEED).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    x = params["embed"]["table"][jnp.asarray(tokens)]
    positions = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    period = len(params["blocks"])
    for layer in range(cfg.n_layers):
        g, pos = divmod(layer, period)
        group = jax.tree.map(lambda a: a[g], params["blocks"][pos])  # noqa: B023
        want, want_aux = ref_blocks.apply_layer(group, x, ref_cfg, pos, positions)
        got, aux = blocks.apply_layer(model.blocks[layer], convert.tensor_from_numpy(
            np.asarray(x), "cpu"), cfg, layer, convert.tensor_from_numpy(positions, "cpu"))
        assert got.dtype == torch.bfloat16
        assert _rel(got, np.asarray(want, np.float32)) <= BF16_LAYER_TOL, layer
        assert (float(aux) > 0) == (blocks.layer_kind(cfg, layer)[1] == "moe")
        x = want


# --------------------------------------------------------------------------
# configuration, conversion, initialization, refusals
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_moe_configs_are_ported(name):
    assert name in configs.PORTED
    assert asdict(configs.get_config(name)) == asdict(ref_get_config(name))
    cfg = configs.get_config(name)
    assert cfg.n_experts and cfg.top_k and cfg.moe_d_ff


def test_only_the_encdec_and_vision_models_wait():
    """Nothing waits any more: every name of the reference's registry is
    ported, the encoder-decoder and vision models included."""
    assert configs.PORTED == configs.ARCH_NAMES and len(configs.ARCH_NAMES) == 10
    assert not hasattr(configs, "WAITS")
    for name in configs.ARCH_NAMES:
        assert configs.get_config(name).name == name


def test_lm_from_numpy_keeps_the_fp32_leaves_under_a_dtype():
    """``dtype=bfloat16`` on fp32 weights gives the dtypes the reference's
    own bf16 model has: the router and the SSM's A_log, D and dt_bias stay
    fp32, every other leaf is bf16."""
    name = "jamba-v0.1-52b"
    f32 = replace(ref_get_smoke(name), dtype="float32")
    params = _numpy(ref_init_params(jax.random.PRNGKey(3), f32))
    model = convert.lm_from_numpy(params, _port_cfg(f32), device="cpu", dtype=torch.bfloat16)
    bf16 = ref_init_params(jax.random.PRNGKey(3), replace(f32, dtype="bfloat16"))
    want = {}
    for pos, tree in enumerate(bf16["blocks"]):
        for part, leaves in tree.items():
            for key, leaf in leaves.items():
                for g in range(leaf.shape[0]):
                    want[f"blocks.{g * len(bf16['blocks']) + pos}.{part}.{key}"] = (
                        str(leaf.dtype))
    got = {n: str(t.dtype).split(".")[-1] for n, t in model.named_parameters()
           if n.startswith("blocks.")}
    assert got == want
    kept = {n.rsplit(".", 1)[-1] for n, d in got.items() if d == "float32"}
    assert kept == {"router", "A_log", "D", "dt_bias"}
    assert model.embed.table.dtype == torch.bfloat16
    # the values: fp32 leaves exactly, the others rounded once
    moe1 = model.blocks[1].moe
    assert np.array_equal(moe1.router.numpy(), params["blocks"][1]["moe"]["router"][0])


def test_init_params_draws_the_reference_distributions():
    cfg = configs.get_smoke("olmoe-1b-7b")
    model = init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    p = model.blocks[0].moe
    assert model.blocks[0].mlp is None and p.router.dtype == torch.float32
    assert p.wi.dtype == torch.bfloat16 and p.wg.shape == (cfg.n_experts, cfg.d_model,
                                                           cfg.moe_d_ff)
    assert abs(float(p.router.std()) - cfg.d_model ** -0.5) < 0.02
    assert abs(float(p.wi.float().std()) - cfg.d_model ** -0.5) < 0.02
    assert abs(float(p.wo.float().std()) - cfg.moe_d_ff ** -0.5) < 0.03
    relu = replace(cfg, act="sq_relu")
    assert init_params(relu, generator=torch.Generator(), device="cpu").blocks[0].moe.wg is None


def test_a_layer_without_the_ffn_its_config_asks_for_raises():
    cfg = replace(configs.get_smoke("jamba-v0.1-52b"), dtype="float32")
    model = init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    tokens = {"tokens": torch.zeros((1, 8), dtype=torch.long)}
    swapped = replace(cfg, moe_offset=0)  # MoE now asked of the even layers
    with pytest.raises(ValueError, match=r"layer 0: the config asks for FFN 'moe', the "
                                         r"model's layer holds 'mlp'"):
        forward(model, swapped, tokens)
    state = init_decode_state(model, cfg, 1, 8)
    with pytest.raises(ValueError, match="layer 0"):
        decode_step(model, swapped, state, tokens["tokens"][:, :1])
    with pytest.raises(ValueError, match="one FFN"):
        blocks.Layer(model.blocks[1].norm1, ssm=model.blocks[1].ssm,
                     norm2=model.blocks[1].norm2, mlp=model.blocks[0].mlp,
                     moe=model.blocks[1].moe)
