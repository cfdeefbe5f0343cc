"""One train step of the port under tensor parallelism against the JAX
package's jitted make_train_step on the CPU, over gloo (tests/
torch_procs.py): (data 1, model 2) on 2 processes against
num_devices=1 and (data 2, model 2) on 4 processes against num_devices=2,
the tiny detector with --tp_attention (B4's plain version head-sharded)
on the same weights and the same 4 images (each data rank its share).
Tolerances are test_torch_distributed.py's: the losses 1e-4 relative +
1e-6, the parameters after the update 5e-6 + 1e-4 relative; the loss and
grad_norm the same on every rank, and the replicated parameters bit for
bit equal on every rank."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spe_tpu.train.optim import make_optimizer
from spe_tpu.train.train_step import Gates as JGates
from spe_tpu.train.train_step import TrainState as JState
from spe_tpu.train.train_step import make_train_step
from spe_tpu_torch.models.convert import state_dict_from_jax
from test_torch_distributed import CFG, SUMMED, _batch
from test_torch_train_step import _jax_params
from torch_procs import start, wait

TP_CFG = {**CFG, "nheads": 4, "model_axis": 2, "use_pallas_attention": True,
          "tp_attention": True}

WORKER = r"""
from spe_tpu_torch import config
from spe_tpu_torch.models.build import build_model
from spe_tpu_torch.parallel import dist
from spe_tpu_torch.parallel.mesh import make_mesh
from spe_tpu_torch.parallel.sharding_rules import (gather_model_state,
                                                   load_full_state_dict)
from spe_tpu_torch.train.optim import AdamW3
from spe_tpu_torch.train.train_step import Gates, TrainState, train_step
dist.init_distributed(world, url, "cpu")
mesh = make_mesh(world, 2)
spec = torch.load(f"{tmp}/step.pt")
cfg = config.SPEConfig(**spec["cfg"])
model = build_model(cfg, "cpu", tp=mesh.tp)
load_full_state_dict(model, spec["weights"])
state = TrainState(model, AdamW3(model.named_parameters(), cfg, 10))
n = 4 // mesh.data_size
share = {k: v[mesh.data_index * n:(mesh.data_index + 1) * n]
         for k, v in spec["batch"].items()}
m = train_step(state, share, cfg, Gates.for_epoch(cfg, 0),
               torch.Generator().manual_seed(mesh.data_index))
out = {"metrics": {k: float(v) for k, v in m.items()},
       "params": gather_model_state(model),
       "replicated": {n: p.detach() for n, p in model.named_parameters()
                      if not hasattr(p, "tp_shard")}}
torch.save(out, f"{tmp}/rank{rank}.pt")
dist.shutdown()
print(f"WORKER DONE rank={rank}", flush=True)
"""


@pytest.mark.parametrize("data", [1, 2])
def test_tp_step_matches_jax(rng, tmp_path, data):
    world = 2 * data
    jcfg, jmodel, params = _jax_params(rng, {**CFG, "nheads": 4})
    batch = _batch(rng)
    before = state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params["params"]))
    torch.save({"cfg": TP_CFG, "weights": before,
                "batch": {k: torch.from_numpy(v) for k, v in batch.items()}},
               tmp_path / "step.pt")
    procs = start(WORKER, "tp step", world, tmp_path)   # JAX meanwhile
    tx = make_optimizer(jcfg, steps_per_epoch=10, params=params)
    step = jax.jit(make_train_step(jmodel, jcfg, tx, num_devices=data))
    jstate, m = jax.block_until_ready(step(
        JState(jnp.int32(0), params, tx.init(params), jnp.int32(0)),
        {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0), JGates.for_epoch(jcfg, 0)))
    want = {k: float(v) for k, v in m.items()}
    after = state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate.params["params"]))
    wait(procs, "tp step")
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(world)]
    got = [r["metrics"] for r in ranks]

    assert want["bad_steps"] == 0 and all(g["bad_steps"] == 0 for g in got)
    for k in ("loss", "grad_norm"):   # the data ranks' mean: global
        assert len({g[k] for g in got}) == 1, (k, [g[k] for g in got])
        assert got[0][k] == pytest.approx(want[k], rel=1e-4, abs=1e-6), k
    terms = [k for k in want if any(s in k for s in SUMMED)]
    assert len(terms) >= 10, terms
    for k in terms:   # each model group's own; the data ranks' mean global
        mean = sum(got[2 * d][k] for d in range(data)) / data
        assert all(got[2 * d + 1][k] == got[2 * d][k] for d in range(data))
        assert mean == pytest.approx(want[k], rel=1e-4, abs=1e-6), k
    for rk in ranks[1:]:
        for n, p in ranks[0]["replicated"].items():
            assert torch.equal(p, rk["replicated"][n]), n
    p0 = ranks[0]["params"]
    assert set(p0) == set(after)
    moved = 0.0
    for name, w in after.items():
        diff = (p0[name] - w).abs()
        bad = diff > 5e-6 + 1e-4 * w.abs()
        assert not bad.any(), (name, float(diff[bad].max()))
        moved = max(moved, float((w - before[name]).abs().max()))
    assert moved > 1e-4   # the step moved the weights
