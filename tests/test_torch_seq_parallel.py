"""The port's sequence parallelism (spe_tpu_torch/ops/seq_parallel.py and
TransformerEncoderLayer's kv_shard_group) on 2 and 4 processes over gloo
(tests/torch_procs.py), the counterparts of tests/test_seq_parallel.py
:38-121: each process holds a quarter or half of the keys and values (and
of the padding mask), the queries whole, against the JAX package's
unsharded attention on the same inputs.

  * kv_sharded_attention and ring_kv_attention: the output (2e-5);
  * their gradients of sum(out^2): dq (all-reduced) and each process's
    dk, dv shards against the unsharded gradients (2e-5);
  * a shard whose keys are all padding does not poison the merge;
  * TransformerEncoderLayer(kv_shard_group=the group), every input whole
    on every process, against the JAX TransformerEncoderLayer unsharded on
    its parameters: the output and every parameter's gradient of
    sum(out * c), c a random cotangent, on every process (2e-5 of each
    one's largest).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spe_tpu.models.transformer import \
    TransformerEncoderLayer as JEncoderLayer
from spe_tpu_torch.models.convert import encoder_layer_state_dict
from torch_procs import start, wait

B, H, NQ, NK, DH, DV, D, F = 2, 4, 16, 64, 8, 8, 16, 24
WORLDS = (2, 4)

WORKER = r"""
from spe_tpu_torch.models.transformer import TransformerEncoderLayer
from spe_tpu_torch.ops.seq_parallel import (kv_sharded_attention,
                                            ring_kv_attention)
from spe_tpu_torch.parallel import dist
dist.init_distributed(world, url, "cpu")
spec = torch.load(f"{tmp}/spec.pt")
n = spec["k"].shape[2] // world
keys = slice(rank * n, (rank + 1) * n)
out = {}
for name, fn in (("kv", kv_sharded_attention), ("ring", ring_kv_attention)):
    q = spec["q"].clone().requires_grad_()
    k = spec["k"][:, :, keys].clone().requires_grad_()
    v = spec["v"][:, :, keys].clone().requires_grad_()
    y = fn(q, k, v, key_padding_mask_local=spec["mask"][:, keys])
    (y ** 2).sum().backward()
    out[name] = (y.detach(), q.grad, k.grad, v.grad)
    out[name + "_pad"] = fn(spec["q"], spec["k"][:, :, keys],
                            spec["v"][:, :, keys],
                            key_padding_mask_local=spec["pad"][:, keys])
layer = TransformerEncoderLayer(*spec["layer"],
                                kv_shard_group=torch.distributed.group.WORLD)
layer.load_state_dict(spec["enc"])
y = layer(spec["x"], spec["pos"], spec["mask"])
(y * spec["cot"]).sum().backward()
out["enc"] = (y.detach(), {n: p.grad for n, p in layer.named_parameters()})
torch.save(out, f"{tmp}/rank{rank}.pt")
dist.shutdown()
print(f"WORKER DONE rank={rank}", flush=True)
"""


def _ref(q, k, v, mask):
    qf = q / jnp.sqrt(q.shape[-1]).astype(q.dtype)
    logits = jnp.einsum("bhqd,bhkd->bhqk", qf, k)
    logits = jnp.where(mask[:, None, None, :], -1e9, logits)
    attn = jax.nn.softmax(logits, axis=-1)
    return jnp.einsum("bhqk,bhkd->bhqd", attn, v)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Both groups' outputs and the JAX references on one set of inputs."""
    rng = np.random.default_rng(0)
    mk = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    q, k, v = mk(B, H, NQ, DH), mk(B, H, NK, DH), mk(B, H, NK, DV)
    mask = rng.uniform(size=(B, NK)) > 0.8
    pad = np.zeros((B, NK), bool)
    pad[:, -NK // 4:] = True     # the last quarter all padding
    x, pos, cot = mk(B, NK, D), mk(B, NK, D), mk(B, NK, D)
    jenc = JEncoderLayer(H, F)
    params = jenc.init(jax.random.PRNGKey(0), x, pos)["params"]
    sd = encoder_layer_state_dict(jax.tree_util.tree_map(np.asarray, params))
    spec = {"q": q, "k": k, "v": v, "mask": mask, "pad": pad, "x": x,
            "pos": pos, "cot": cot, "layer": (D, H, F), "enc": sd}
    runs = {}
    for world in WORLDS:
        tmp = tmp_path_factory.mktemp(f"sp{world}")
        torch.save({n: torch.from_numpy(a) if isinstance(a, np.ndarray)
                    else a for n, a in spec.items()}, tmp / "spec.pt")
        runs[world] = (tmp, start(WORKER, f"sp {world}", world, tmp))

    args = [jnp.asarray(a) for a in (q, k, v)]
    want = {"out": _ref(*args, jnp.asarray(mask)),
            "grads": jax.jit(jax.grad(lambda a, b, c: jnp.sum(
                _ref(a, b, c, jnp.asarray(mask)) ** 2), argnums=(0, 1, 2)))(
                    *args),
            "pad": _ref(*args, jnp.asarray(pad))}

    def enc(params):
        return jenc.apply({"params": params}, x, pos,
                          key_padding_mask=jnp.asarray(mask))
    want["enc"] = (enc(params), encoder_layer_state_dict(
        jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(
            lambda p: jnp.sum(enc(p) * cot)))(params))))
    got = {}
    for world, (tmp, procs) in runs.items():
        wait(procs, f"sp {world}")
        got[world] = [torch.load(tmp / f"rank{r}.pt") for r in range(world)]
    return got, want


def _close(a, b, name, tol=2e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol, err_msg=name)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("fn", ["kv", "ring"])
def test_matches_unsharded(groups, fn, world):
    got, want = groups
    for r, rk in enumerate(got[world]):
        _close(rk[fn][0], want["out"], f"{fn} rank {r}")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("fn", ["kv", "ring"])
def test_grads_match_unsharded(groups, fn, world):
    got, want = groups
    dq, dk, dv = (np.asarray(g) for g in want["grads"])
    n = NK // world
    for r, rk in enumerate(got[world]):
        keys = slice(r * n, (r + 1) * n)
        _close(rk[fn][1], dq, f"{fn} dq rank {r}")
        _close(rk[fn][2], dk[:, :, keys], f"{fn} dk rank {r}")
        _close(rk[fn][3], dv[:, :, keys], f"{fn} dv rank {r}")


@pytest.mark.parametrize("world", WORLDS)
def test_fully_masked_shard(groups, world):
    """The last process's keys are all padding: the merge ignores them."""
    got, want = groups
    for r, rk in enumerate(got[world]):
        for fn in ("kv", "ring"):
            assert torch.isfinite(rk[fn + "_pad"]).all()
            _close(rk[fn + "_pad"], want["pad"], f"{fn} rank {r}")


def _rel(got, want, name, tol=2e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err, top = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * top, (name, err, top)


@pytest.mark.parametrize("world", WORLDS)
def test_encoder_layer_kv_shard_group(groups, world):
    got, want = groups
    y, grads = want["enc"]
    for r, rk in enumerate(got[world]):
        _rel(rk["enc"][0], y, f"out rank {r}")
        assert set(rk["enc"][1]) == set(grads)
        for n, g in grads.items():
            _rel(rk["enc"][1][n], g, f"{n} rank {r}")


def test_encoder_kv_shard_refuses_dropout():
    """As the JAX module refuses it (models/attention.py:225-229): the
    merged softmax spans processes, a mask per process would change it."""
    from spe_tpu_torch.models.transformer import TransformerEncoderLayer

    layer = TransformerEncoderLayer(D, H, F, dropout=0.1,
                                    kv_shard_group=object()).train()
    x = torch.zeros(B, NK, D)
    with pytest.raises(ValueError, match="dropout"):
        layer(x, x, gen=torch.Generator())
