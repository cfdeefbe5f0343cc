"""The port's tensor parallelism (spe_tpu_torch.parallel: mesh, tp,
sharding_rules) against the JAX package on the CPU.

  * every parameter's spec ("col", "row", "replicated") equals the JAX
    rules' (tp_param_shardings) for its counterpart;
  * check_tp_fused_compat refuses what the JAX one refuses
    (tests/test_tp_sharding.py:158-182), naming the same flags;
  * shard_state_dict / gather_state_dict round-trip bit for bit, and a
    rank's packed in-projection rows are the q, k and v rows of its heads;
  * on 2 processes over gloo (tests/torch_procs.py), a model group of 2:
    the head-sharded B4 (fused_mha's plain version on the rank's heads)
    against the JAX fused_mha(tp_mesh=make_mesh(1, 2)) in interpret mode
    (outputs 1e-5, gradients 2e-4); the TP detector's forward, post-norm
    with --tp_attention and pre-norm plain, against the JAX TP forward on
    a (1, 2) mesh (5e-4) and against the port's one-process forward (2e-5
    of the largest magnitude); and a TP train step with every dropout on
    against the one-process step on the same generator seed: the masks are
    keyed by global head and column, so the losses agree to 1e-5 relative,
    the gradients to 1e-4 of each one's largest + 1e-6, the clip's norm to
    1e-4 relative, Adam's moments to what that gradient bound allows, and
    the parameters after the update to 5e-6 + 1e-4 relative wherever the
    clipped gradient is above Adam's eps (below it the first step turns on
    the gradient's rounding); the replicated parameters are bit for bit
    equal on both ranks;
  * with use_fused_ca_block on and no tp_attention (accepted, as the JAX
    package accepts it), the TP forward against the one-process forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from spe_tpu.config import SPEConfig as JConfig
from spe_tpu.models.build import build_model as jax_build_model
from spe_tpu.ops.pallas_mha import fused_mha as jax_mha
from spe_tpu.parallel.mesh import make_mesh as jax_mesh
from spe_tpu.parallel.sharding_rules import \
    check_tp_fused_compat as jax_check
from spe_tpu.parallel.sharding_rules import tp_param_shardings
from spe_tpu_torch import config as tconfig
from spe_tpu_torch.models.build import build_model
from spe_tpu_torch.models.convert import state_dict_from_jax
from spe_tpu_torch.ops.kernel_checks import zero_grad_ref
from spe_tpu_torch.parallel import sharding_rules as rules
from spe_tpu_torch.train.optim import ADAM_EPS, B1, B2, AdamW3
from spe_tpu_torch.train.train_step import Gates, TrainState, train_step
from test_torch_detector import _near_one
from test_torch_train_step import CFG, _batches
from torch_procs import start, wait

TP_CFG = {**CFG, "nheads": 4}
DROP = dict(dropout=0.2, backbone_drop_rate=0.2, drop_path_rate=0.2,
            drop_attn_rate=0.2)


def _sync(fn, *args):
    """fn(*args) as one jitted JAX call, waited for before anything else
    is dispatched (the threaded Pallas interpreter; ROADMAP §C)."""
    return jax.block_until_ready(jax.jit(fn)(*args))


def _mesh12():
    return jax_mesh(num_data=1, num_model=2, devices=jax.devices()[:2])


def _params(cfg, rng):
    """JAX init of cfg's detector (its plain build, so that no kernel runs
    eagerly), branches made visible -> (params, the port's whole state
    dict of them)."""
    plain = jax_build_model(JConfig(**{**cfg, "use_pallas_attention": False,
                                       "tp_attention": False}))
    params = plain.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 64, 64, 3), jnp.float32))
    params = {"params": _near_one(params["params"], rng)}
    return params, state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params["params"]))


# ------------------------------------------------------------ the rules

def test_param_specs_match_jax_rules():
    cfg = {**TP_CFG, "masks": True, "pre_norm": True,
           "position_embedding": "learned"}
    jcfg = JConfig(**cfg)
    params = jax_build_model(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32))
    shardings = tp_param_shardings(params, _mesh12(), jcfg)
    code = {P(): 0.0, P(None, "model"): 1.0, P("model", None): 2.0}
    coded = jax.tree_util.tree_map(
        lambda s, leaf: np.full(leaf.shape, code[s.spec], np.float32),
        shardings, params)
    want = {n: {0.0: "replicated", 1.0: "col", 2.0: "row"}[
        float(t.flatten()[0])] for n, t in
        state_dict_from_jax(coded["params"]).items()
        if bool((t == t.flatten()[0]).all())}
    got = rules.tp_param_specs(build_model(tconfig.SPEConfig(**cfg), "cpu"))
    assert set(want) == set(got), set(want) ^ set(got)
    assert got == want
    kinds = list(got.values())
    assert kinds.count("col") >= 30 and kinds.count("row") >= 15, kinds
    assert got["transformer.encoder.layers.0.self_attn.in_proj_weight"] \
        == "col"
    assert got["bbox_attention.q_linear.weight"] == "col"


@pytest.mark.parametrize("flags, match", [
    (dict(use_pallas_attention=True), "tp_attention"),
    (dict(use_pallas_attention=True, tp_attention=True, nheads=8), None),
    (dict(use_pallas_attention=True, tp_attention=True,
          use_fused_block=True), "use_fused_block"),
    (dict(use_fused_layers=True), "use_fused_layers"),
    (dict(use_pallas_attention=True, tp_attention=True, nheads=3),
     "divisible")])
def test_tp_fused_compat_matches_jax(flags, match):
    mesh = jax_mesh(num_data=4, num_model=2)
    errors = []
    for check, axis, cfg in ((jax_check, mesh, JConfig(**flags)),
                             (rules.check_tp_fused_compat, 2,
                              tconfig.SPEConfig(**flags))):
        if match is None:
            check(cfg, axis)
            continue
        with pytest.raises(ValueError, match=match) as e:
            check(cfg, axis)
        errors.append(str(e.value))
    for flag in ("--no_use_fused_block", "--no_use_fused_layers",
                 "--no_use_pallas_attention", "--tp_attention"):
        assert len({flag in m for m in errors}) <= 1, (flag, errors)
    # a model axis of 1 refuses nothing
    rules.check_tp_fused_compat(tconfig.SPEConfig(**flags), 1)


@pytest.mark.parametrize("count", [2, 4])
def test_shard_gather_round_trip(count):
    sd = build_model(tconfig.SPEConfig(**TP_CFG), "cpu").state_dict()
    parts = [rules.shard_state_dict(sd, i, count) for i in range(count)]
    back = rules.gather_state_dict(parts)
    assert list(back) == list(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    name = "transformer.encoder.layers.0.self_attn.in_proj_weight"
    w, D = sd[name], sd[name].shape[1]
    n = D // count
    for i, p in enumerate(parts):
        assert torch.equal(p[name], torch.cat(
            [w[j * D + i * n:j * D + (i + 1) * n] for j in range(3)]))
        assert p["transformer.decoder.layers.0.linear1.weight"].shape == (
            TP_CFG["dim_feedforward"] // count, D)
        assert p["transformer.decoder.layers.0.linear2.weight"].shape == (
            D, TP_CFG["dim_feedforward"] // count)
        assert p["transformer.decoder.layers.0.linear1.bias"].shape == (
            TP_CFG["dim_feedforward"],)


# ------------------------------------------------- a model group of two

WORKER = r"""
from spe_tpu_torch import config
from spe_tpu_torch.models.build import build_model
from spe_tpu_torch.ops.fused_mha import fused_mha
from spe_tpu_torch.parallel import dist
from spe_tpu_torch.parallel.mesh import make_mesh
from spe_tpu_torch.parallel.sharding_rules import (gather_model_state,
                                                   gather_tensors,
                                                   load_full_state_dict)
from spe_tpu_torch.train.optim import AdamW3
from spe_tpu_torch.train.train_step import Gates, TrainState, train_step
dist.init_distributed(world, url, "cpu")
mesh = make_mesh(world, 2)
spec = torch.load(f"{tmp}/spec.pt")
out = {}


def model_of(name):
    cfg = config.SPEConfig(**spec["cfgs"][name])
    model = build_model(cfg, "cpu", tp=mesh.tp)
    load_full_state_dict(model, spec["weights"][name])
    return cfg, model


for name in ("post", "pre", "ca"):
    cfg, model = model_of(name)
    with torch.no_grad():
        o = model(spec["images"])
    out[name] = {"cams": o["backbone"]["cams_cls"], **{
        f"{k}{r}": st[k] for r, st in o["stages"].items()
        for k in ("pred_logits", "pred_boxes")}}


def mine(t):   # this rank's heads: its half of the columns
    n = t.shape[-1] // 2
    return t[..., rank * n:(rank + 1) * n].clone().requires_grad_()


for form, (q, k, v, mask, cot, H) in spec["mha"].items():
    ql, kl, vl = mine(q), mine(k), mine(v)
    y = fused_mha(ql, kl, vl, H // 2, mask)
    (y * mine(cot).detach()).sum().backward()
    out[form] = (y.detach(), ql.grad, kl.grad, vl.grad)

cfg, model = model_of("drop")
opt = AdamW3(model.named_parameters(), cfg, 10)
state = TrainState(model, opt)
m = train_step(state, spec["batch"], cfg, Gates.for_epoch(cfg, 0),
               torch.Generator().manual_seed(11))
out["drop"] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "params": gather_model_state(model),
               "grads": gather_tensors([(n, p.grad) for n, p in
                                        model.named_parameters()], mesh.tp),
               **{k: gather_tensors([
                   (n, t) for g in opt.groups
                   for n, t in zip(opt.names[g], getattr(opt, k)[g])],
                   mesh.tp) for k in ("exp_avg", "exp_avg_sq")},
               "replicated": {n: p.detach().clone() for n, p in
                              model.named_parameters()
                              if not hasattr(p, "tp_shard")},
               "collectives": mesh.tp.calls}
torch.save(out, f"{tmp}/rank{rank}.pt")
dist.shutdown()
print(f"WORKER DONE rank={rank}", flush=True)
"""


def _mha_inputs(rng, dq, dv, B=2, H=4, Nq=10, Nk=24):
    mk = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    q, k, v = mk(B, H, Nq, dq), mk(B, H, Nk, dq), mk(B, H, Nk, dv)
    mask = np.zeros((B, Nk), bool)
    mask[1, -5:] = True
    return q, k, v, mask, mk(B, H, Nq, dv)


def _flat(t):   # (B, H, N, d) -> the port's (B, N, H*d)
    B, H, N, d = t.shape
    return torch.from_numpy(np.ascontiguousarray(
        t.transpose(0, 2, 1, 3).reshape(B, N, H * d)))


def _close(got, want, rtol, atol, name):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=name)


def _rel(got, want, rel, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err, top = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * top, (name, err, top)


def test_tp_group_matches_jax_and_one_process(rng, tmp_path):
    cfgs = {"post": {**TP_CFG, "model_axis": 2, "use_pallas_attention": True,
                     "tp_attention": True},
            "pre": {**TP_CFG, "model_axis": 2, "pre_norm": True},
            "drop": {**TP_CFG, **DROP, "model_axis": 2,
                     "use_pallas_attention": True, "tp_attention": True}}
    params, weights = {}, {}
    for name, cfg in cfgs.items():
        params[name], weights[name] = _params(cfg, rng)
    # the fused class attention asked for under TP without tp_attention
    # (the JAX package accepts it): the block runs its plain version on
    # the rank's heads, held against the one-process forward, whose block
    # is fused
    cfgs["ca"] = {**TP_CFG, "model_axis": 2, "use_fused_ca_block": "on"}
    _, weights["ca"] = _params({**cfgs["ca"], "use_fused_ca_block": "off"},
                               np.random.default_rng(1))
    images = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    mha = {form: _mha_inputs(rng, dq, dv)
           for form, dq, dv in (("encoder", 8, 8), ("cross", 16, 8))}
    batch = {k: torch.from_numpy(v) for k, v in _batches(rng)[0].items()}
    torch.save({"cfgs": cfgs, "weights": weights,
                "images": torch.from_numpy(images), "batch": batch,
                "mha": {f: (_flat(q), _flat(k), _flat(v),
                            torch.from_numpy(mask), _flat(cot), q.shape[1])
                        for f, (q, k, v, mask, cot) in mha.items()}},
               tmp_path / "spec.pt")
    procs = start(WORKER, "tp", 2, tmp_path)   # the JAX side meanwhile

    mesh = _mesh12()
    x = jnp.asarray(images)
    want_jax = {}
    for name in ("post", "pre"):
        jcfg = JConfig(**cfgs[name])
        model = jax_build_model(jcfg, tp_mesh=mesh if jcfg.tp_attention
                                else None)
        sh = tp_param_shardings(params[name], mesh, jcfg)
        bs = NamedSharding(mesh, P("data"))
        o = jax.block_until_ready(jax.jit(model.apply, in_shardings=(
            sh, bs))(jax.device_put(params[name], sh), jax.device_put(x, bs)))
        want_jax[name] = {"cams": o["backbone"]["cams_cls"], **{
            f"{k}{r}": o["stages"][r][k] for r in (0, 1)
            for k in ("pred_logits", "pred_boxes")}}
    want_mha = {}
    for form, (q, k, v, mask, cot) in mha.items():
        def loss(q, k, v, mask=mask, cot=cot):
            y = jax_mha(q, k, v, key_padding_mask=jnp.asarray(mask),
                        interpret=True, tp_mesh=mesh)
            return (y * cot).sum(), y
        (_, y), g = _sync(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                             has_aux=True),
                          jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want_mha[form] = [y, *g]

    one = {}
    for name in ("post", "pre", "ca"):
        model = build_model(tconfig.SPEConfig(**{**cfgs[name],
                                                 "model_axis": 1}), "cpu")
        model.load_state_dict(weights[name])
        with torch.no_grad():
            o = model(torch.from_numpy(images))
        one[name] = {"cams": o["backbone"]["cams_cls"], **{
            f"{k}{r}": o["stages"][r][k] for r in (0, 1)
            for k in ("pred_logits", "pred_boxes")}}
    dcfg = tconfig.SPEConfig(**{**cfgs["drop"], "model_axis": 1})
    model = build_model(dcfg, "cpu")
    model.load_state_dict(weights["drop"])
    opt = AdamW3(model.named_parameters(), dcfg, 10)
    m = train_step(TrainState(model, opt), batch, dcfg,
                   Gates.for_epoch(dcfg, 0), torch.Generator().manual_seed(11))
    one_step = (float(m["loss"]), float(m["grad_norm"]),
                {n: p.detach() for n, p in model.named_parameters()},
                {n: p.grad for n, p in model.named_parameters()},
                {k: {n: t for g in opt.groups
                     for n, t in zip(opt.names[g], getattr(opt, k)[g])}
                 for k in ("exp_avg", "exp_avg_sq")})

    wait(procs, "tp")
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in (0, 1)]
    for name in ("post", "pre"):
        for key, w in want_jax[name].items():
            for r, rk in enumerate(ranks):
                _close(rk[name][key], w, 5e-4, 5e-4, f"{name} {key} rank {r}")
                _rel(rk[name][key], one[name][key], 2e-5,
                     f"{name} {key} rank {r} vs one process")
    for key, w in one["ca"].items():
        for r, rk in enumerate(ranks):
            _rel(rk["ca"][key], w, 2e-5, f"ca {key} rank {r} vs one process")
    for form, want in want_mha.items():
        H = mha[form][0].shape[1]
        for r, rk in enumerate(ranks):
            heads = slice(r * H // 2, (r + 1) * H // 2)
            for i, (g, w) in enumerate(zip(rk[form], want)):
                tol = 1e-5 if i == 0 else 2e-4
                _close(g, _flat(np.asarray(w)[:, heads]), tol, tol,
                       f"{form} {'out dq dk dv'.split()[i]} rank {r}")
    d0, d1 = ranks[0]["drop"], ranks[1]["drop"]
    assert d0["loss"] == d1["loss"] and d0["grad_norm"] == d1["grad_norm"]
    assert d0["loss"] == pytest.approx(one_step[0], rel=1e-5)
    assert d0["grad_norm"] == pytest.approx(one_step[1], rel=1e-4)
    assert set(d0["replicated"]) == set(d1["replicated"])
    for n, p in d0["replicated"].items():
        assert torch.equal(p, d1["replicated"][n]), n
    # the gradients within 1e-4 of the largest of each (a bias whose exact
    # gradient is zero, a softmax row's shift, of its weight's) + 1e-6
    # (decoder layer 0's self-attention sees tgt = 0: some of its
    # gradients are zero up to rounding on both sides): dg. With the clip
    # factors c = min(1, clip / grad_norm) of both runs the clipped
    # gradients differ by at most dc = c dg + |c - c_one| |g_one|, Adam's
    # first moments by (1 - b1) dc and the square roots of the second by
    # sqrt(1 - b2) dc. The parameters after the update within 5e-6 + 1e-4
    # relative, but where the one-process clipped gradient is below Adam's
    # eps (1e-8): there the first step lr g / (|g| + eps) is ~ lr g / eps,
    # 1e5 times the gradient's rounding at lr 1e-3 (the clip scales this
    # step's gradients by ~5e-4, which puts about a quarter of them there)
    clips = [min(1.0, dcfg.clip_max_norm / n)
             for n in (d0["grad_norm"], one_step[1])]
    moved, left_out, total = 0.0, 0, 0
    for n, w in one_step[2].items():
        ref = zero_grad_ref(n)
        g, gw = d0["grads"][n], one_step[3][n]
        top = float(one_step[3][ref or n].abs().max())
        dg = 1e-4 * top + 1e-6
        assert float((g - gw).abs().max()) <= dg, (n, top)
        dc = clips[0] * dg + abs(clips[0] - clips[1]) * gw.abs()
        m, m1 = d0["exp_avg"][n], one_step[4]["exp_avg"][n]
        assert not ((m - m1).abs() > (1 - B1) * dc).any(), (n, "exp_avg")
        v, v1 = d0["exp_avg_sq"][n], one_step[4]["exp_avg_sq"][n]
        assert not ((v.sqrt() - v1.sqrt()).abs()
                    > (1 - B2) ** 0.5 * dc).any(), (n, "exp_avg_sq")
        held = (gw * clips[1]).abs() >= ADAM_EPS
        got = d0["params"][n]
        bad = held & ((got - w).abs() > 5e-6 + 1e-4 * w.abs())
        assert not bad.any(), (n, float((got - w)[held].abs().max()))
        left_out += int((~held).sum())
        total += held.numel()
        moved = max(moved, float((w - weights["drop"][n]).abs().max()))
    assert left_out < 0.5 * total, (left_out, total)
    assert moved > 1e-4 and d0["collectives"] > 50
