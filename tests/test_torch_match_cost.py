"""`--log_match_cost`, the matching-cost audit, against the JAX package on
numpy-seeded costs and stage outputs: realized_assignment_cost and
set_criterion_multi(cost_trace=True)'s match_subopt_mean/max within 1e-5
(f32 sums of the same picked costs), the exact solver's own gap 0 and the
auction's never below it by more than 1e-6, and the CLI's log.txt."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spe_tpu.train import criterion as jcrit
from spe_tpu_torch.data import write_mini_voc
from spe_tpu_torch.ops.auction import (auction_assignment_stats_batched,
                                       hungarian_batched)
from spe_tpu_torch.train import criterion as tcrit

TOL = dict(rtol=1e-5, atol=1e-5)


def _costs(rng, P, Q, T):
    cost = rng.normal(size=(P, Q, T)).astype(np.float32)
    mask = rng.uniform(size=(P, T)) > 0.3
    mask[:, 0] = True
    return np.where(mask[:, None, :], cost, 1e4).astype(np.float32), mask


@pytest.mark.parametrize("P, Q, T", [(6, 12, 5), (4, 10, 10), (5, 6, 15)])
def test_realized_assignment_cost_matches_jax(rng, P, Q, T):
    """Under-, fully and over-subscribed problems (T > Q: some valid
    columns stay without a query, row -1), the auction's rows and random
    ones with a few -1."""
    cost, mask = _costs(rng, P, Q, T)
    rows_a, _, _ = auction_assignment_stats_batched(torch.from_numpy(cost),
                                                    torch.from_numpy(mask))
    rows_r = rng.integers(-1, Q, size=(P, T)).astype(np.int32)
    for rows in (rows_a.numpy(), rows_r):
        want = jcrit.realized_assignment_cost(
            jnp.asarray(cost), jnp.asarray(rows), jnp.asarray(mask))
        got = tcrit.realized_assignment_cost(
            torch.from_numpy(cost), torch.from_numpy(rows),
            torch.from_numpy(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("P, Q, T", [(8, 12, 6), (6, 12, 12)])
def test_exact_gap_is_zero_and_auction_gap_nonnegative(rng, P, Q, T):
    """Problems of no more valid targets than queries. (Past the queries
    the two solvers may give different numbers of valid targets a query,
    and the gap can then fall below 0: the JAX package's audit too.)"""
    cost, mask = _costs(rng, P, Q, T)
    c, m = torch.from_numpy(cost), torch.from_numpy(mask)
    exact = tcrit.assignment_gap(c, hungarian_batched(c, m), m)
    assert torch.equal(exact, torch.zeros(P))
    rows, _, _ = auction_assignment_stats_batched(c, m)
    gap = tcrit.assignment_gap(c, rows, m)
    assert float(gap.min()) >= -1e-6, gap
    assert float(gap.max()) < 2e-2, gap   # the auction's eps band


def _stages(rng, B, Q, K, L):
    out = []
    for _ in range(2):
        lg = [(rng.normal(size=(B, Q, K)) * 2).astype(np.float32)
              for _ in range(L)]
        bx = [np.concatenate([rng.uniform(0.2, 0.8, (B, Q, 2)),
                              rng.uniform(0.05, 0.4, (B, Q, 2))],
                             -1).astype(np.float32) for _ in range(L)]
        out.append({"pred_logits": lg[-1], "pred_boxes": bx[-1],
                    "aux_pred_logits": np.stack(lg[:-1]),
                    "aux_pred_boxes": np.stack(bx[:-1])})
    return out


def _targets(rng, B, T, K, with_scores):
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (B, T, 2)),
                            rng.uniform(0.05, 0.4, (B, T, 2))], -1)
    mask = rng.uniform(size=(B, T)) > 0.3
    mask[:, 0] = True
    t = {"boxes": boxes.astype(np.float32),
         "labels": rng.integers(1, K, size=(B, T)).astype(np.int32),
         "mask": mask}
    if with_scores:
        t["scores"] = np.where(mask, rng.uniform(0.05, 0.9, (B, T)),
                               0).astype(np.float32)
    return t


@pytest.mark.parametrize("assignment, ratio", [("auction", 3),
                                               ("auction", 5),
                                               ("hungarian_cpu", 3)])
def test_set_criterion_cost_trace_matches_jax(rng, assignment, ratio):
    """Two stages of two decoder layers, the box repeat at box_jitter 0; at
    ratio 5 the 4 targets x 5 exceed the 16 queries. match_subopt_mean/max
    and every loss as the JAX package's cost_trace gives them."""
    B, Q, K, T, L = 2, 16, 6, 4, 2
    stages = _stages(rng, B, Q, K, L)
    tg = [_targets(rng, B, T, K, False), _targets(rng, B, T, K, True)]
    kw = dict(hung_match_ratio=ratio, box_jitter=0.0, focal_alpha=0.25,
              focal_gamma=0.5, assignment=assignment, cost_trace=True)
    want = jcrit.set_criterion_multi(
        [{k: jnp.asarray(v) for k, v in s.items()} for s in stages],
        [{k: jnp.asarray(v) for k, v in t.items()} for t in tg],
        [jax.random.PRNGKey(0), jax.random.PRNGKey(1)],
        [jnp.float32(11.0), jnp.float32(7.0)], [False, True], **kw)
    got, _ = tcrit.set_criterion_multi(
        [{k: torch.from_numpy(v) for k, v in s.items()} for s in stages],
        [{k: torch.from_numpy(v) for k, v in t.items()} for t in tg],
        [torch.Generator().manual_seed(0)] * 2,
        [torch.tensor(11.0), torch.tensor(7.0)], [False, True], **kw)
    assert {"match_subopt_mean", "match_subopt_max"} <= set(got[0])
    for s in range(2):
        assert set(got[s]) == set(want[s])
        for k in want[s]:
            np.testing.assert_allclose(np.asarray(got[s][k]),
                                       np.asarray(want[s][k]), **TOL,
                                       err_msg=k)
    assert float(got[0]["match_subopt_max"]) >= -1e-6
    if assignment == "hungarian_cpu":
        assert float(got[0]["match_subopt_max"]) == 0.0


def test_cost_trace_refuses_a_replayed_matching(rng):
    B, Q, K, T = 2, 8, 4, 3
    stage = _stages(rng, B, Q, K, 2)[0]
    stage = {k: torch.from_numpy(v) for k, v in stage.items()}
    tg = {k: torch.from_numpy(v)
          for k, v in _targets(rng, B, T, K, False).items()}
    args = ([stage], [tg], [None], [torch.tensor(3.0)], [False])
    _, matching = tcrit.set_criterion_multi(*args)
    with pytest.raises(ValueError, match="cost_trace"):
        tcrit.set_criterion_multi(*args, matching=matching, cost_trace=True)


def test_cli_logs_match_subopt(tmp_path):
    """A 1-epoch CPU run with --log_match_cost writes the epoch's mean
    train_match_subopt_mean/max into log.txt."""
    from spe_tpu_torch.cli.main import main

    devkit = write_mini_voc(tmp_path / "data", n_trainval=4, n_test=2,
                            img_size=64)
    out = tmp_path / "out"
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = main(["--preset", "voc0712", "--device", "cpu",
                    "--dataset_file", "voc_voc", "--test_path", str(devkit),
                    "--backbone", "TSCAM_cait_tiny", "--max_size", "64",
                    "--layer_to_det", "2", "--enc_layers", "1",
                    "--dec_layers", "2", "--dim_feedforward", "32",
                    "--nheads", "2", "--num_queries", "12",
                    "--batch_size", "2", "--compute_dtype", "float32",
                    "--cam_cc_size", "16", "--max_gt_boxes", "6",
                    "--hung_match_ratio", "3", "--warmup_cls_epochs", "0",
                    "--refine_start_epoch", "0", "--epochs", "1",
                    "--log_match_cost", "--output_dir", str(out)])
    finally:
        torch.set_num_threads(n)
    (rec,) = [json.loads(line) for line in
              (out / "log.txt").read_text().splitlines()]
    hist = res["epochs"][0]["train"]["history"]
    assert len(hist) == 2
    for k in ("match_subopt_mean", "match_subopt_max"):
        assert rec[f"train_{k}"] == pytest.approx(
            sum(h[k] for h in hist) / 2, rel=1e-12)
        assert -1e-6 <= rec[f"train_{k}"] < 2e-2, rec
