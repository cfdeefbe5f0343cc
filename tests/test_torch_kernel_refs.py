"""The plain versions of the backward toolkit's two product kernels, on the
CPU: `kernels.gemm_reference` against an independent gather-and-einsum in
float64 over every operand layout, dtype, ragged edge, split, column
group, accumulate mode and epilogue the port asks of `kernels.gemm`
(kernel_checks.gemm_kernel_cases, the same cases the card tests hold the
kernel to); `kernels.attention_reference` against `fused_mha_reference`,
`fused_mha_train_reference` and `softmax_attention` (held to the JAX
package by their own tests) at small sizes of each of the kernel's four
head-width templates; `kernels.ln_linear_reference` against F.layer_norm,
F.linear, the activation, masks and residual written out in f32 over every
option of kernel_checks.linear_kernel_cases (the cases the card tests hold
linear_kernel to); `kernels.th_bwd_rows_reference` against autograd
through the plain talking-heads softmax and mixes in float64,
`kernels.th_fwd_rows_reference` against that softmax itself, and
`kernels.attention_bwd_rows_reference` against autograd through the
masked softmax with its key bias and dropout; `kernels.colsum_reference`
against a float64 sum and `kernels.th_fold_reference` against the exact
product rounded once (and torch.mul with a bf16 out=);
`kernels.colsum_f32_reference` against a float64 sum and
`kernels.ln_backward_reference` against float64 autograd of F.layer_norm
plus the residual; `kernels.branch_backward_reference` against the
branch's backward in float64 (the counter masks as refmath defines them)
and `kernels.th_dq_reference` against float64 numpy of the TPU kernel's
dQ/dwl loop (spe_tpu/ops/pallas_block.py:430-438) on strided views;
`kernels.layernorm_reference` against float64 numpy of the TPU kernels'
_ln_fwd and `kernels.th_mix_reference` against float64 numpy of the TPU
post-softmax mix (pallas_block.py:143-148) on real softmax rows; and the
grid plans (`colsum_f32_plan`, `ln_backward_plan`, `branch_backward_plan`,
`th_dq_plan`, `layernorm_plan`, `th_mix_plan`) at every class the main
path gives them: each row and column covered once, within one wave. No JAX here: the reference functions it is held to are the port's
own plain versions, torch's and numpy's.

f32 outputs are held to 1e-5 of their largest magnitude (f32 sums against
float64 ones, over bf16-rounded operands whose products are exact in
f32); bf16 outputs to one bf16 ulp at their largest magnitude (a sum on
either side of a rounding boundary)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from spe_tpu_torch.ops import kernels as K
from spe_tpu_torch.ops.fused_encoder import softmax_attention
from spe_tpu_torch.ops.fused_mha import (fused_mha_reference,
                                         fused_mha_train_reference)
from spe_tpu_torch.ops.kernel_checks import (BRANCH_BWD_MAIN,
                                             BRANCH_BWD_SHAPES,
                                             COLSUM_F32_MAIN, COLSUM_REL_TOL,
                                             H100_SMS, LAYERNORM_MAIN,
                                             LN_BWD_MAIN, TH_BWD_MAIN,
                                             TH_BWD_SHAPES, TH_DQ_MAIN,
                                             TH_DQ_SHAPES, TH_MIX_SHAPES,
                                             attn_rows_case, bf16_tol,
                                             branch_backward_case,
                                             colsum_case, colsum_err,
                                             colsum_f32_case,
                                             gemm_kernel_cases, gemm_run,
                                             layernorm_case,
                                             linear_kernel_cases, linear_run,
                                             ln_backward_case, max_err,
                                             storage_of, th_bwd_case,
                                             th_dq_case, th_fold_case,
                                             th_fwd_case)
from spe_tpu_torch.ops.refmath import (SITE_MHA_ATTN, CounterDropout,
                                       counter_keep, key_bias, path_keep)

BF16 = torch.bfloat16
GEMM_CASES = gemm_kernel_cases(device="cpu")


def _index(offset, sizes, strides):
    idx = torch.tensor(offset)
    for d, (n, s) in enumerate(zip(sizes, strides)):
        shape = [1] * len(sizes)
        shape[d] = n
        idx = idx + torch.arange(n).reshape(shape) * s
    return idx


def _gather(t, sizes, strides):
    """t's elements at offset + sum(i_d * stride_d), rounded to bf16, in
    float64."""
    return storage_of(t)[_index(t.storage_offset(), sizes, strides)].to(
        BF16).double()


def _expected_gemm(case):
    """The storage of c after the call, computed element by element."""
    a, b, c, kw = case["a"], case["b"], case["c"], case["kw"]
    M, N, K, (nb1, nb2) = kw["M"], kw["N"], kw["K"], kw["nb"]
    depth = kw.get("split_k")
    if depth is None:
        A = _gather(a, (nb1, nb2, M, K), kw["a_str"])
        B = _gather(b, (nb1, nb2, K, N), kw["b_str"])
        y = torch.einsum("xymk,xykn->xymn", A, B)
    else:
        A = _gather(a, (M, depth), kw["a_str"][2:])
        B = _gather(b, (depth, N), kw["b_str"][2:])
        y = torch.stack([torch.einsum("mk,kn->mn", A[:, z * K:(z + 1) * K],
                                      B[z * K:(z + 1) * K])
                         for z in range(nb1)])[:, None]
    y = kw.get("alpha", 1.0) * y
    if "drop" in kw:
        site, rate = kw["drop"]
        rps = kw["rows_per_sample"]
        keep = counter_keep(kw["seed"], site, rate,
                            (M // rps, 1, rps, N)).reshape(M, N)
        y = torch.where(keep, y / (1.0 - rate), 0.0)
    if "gelu_aux" in kw:
        u = kw["gelu_aux"].double().requires_grad_()
        (du,) = torch.autograd.grad(F.gelu(u, approximate="tanh").sum(), u)
        y = y * du
    if "relu_aux" in kw:
        y = torch.where(kw["relu_aux"] > 0, y, 0.0)
    grp = kw.get("col_group") or N
    n = torch.arange(N)
    s1, s2, sm, sn = kw["c_str"]
    idx = (c.storage_offset() + _index(0, (nb1, nb2, M), (s1, s2, sm))[..., None]
           + (n // grp) * kw.get("col_stride", 0) + (n % grp) * sn)
    out = storage_of(c).clone()
    if kw.get("accumulate"):
        y = y + out[idx].double()
    out[idx] = y.to(c.dtype)
    return out, idx


@pytest.mark.parametrize("case", range(len(GEMM_CASES)),
                         ids=[label for label, _ in GEMM_CASES])
def test_gemm_reference_matches_einsum(case):
    """gemm_reference writes exactly the elements gemm addresses, with the
    product of the bf16-rounded operands and the epilogue in order."""
    _, c = GEMM_CASES[case]
    got = storage_of(gemm_run(K.gemm_reference, c))
    want, idx = _expected_gemm(c)
    top = float(want[idx].double().abs().max())
    tol = bf16_tol(want[idx], ulps=1) if want.dtype == BF16 else 1e-5 * top
    assert top > 0
    assert max_err(got, want) <= tol


def _act(gen, *shape):
    return torch.randn(shape, generator=gen).to(BF16)


def _mask(B, N):
    mask = torch.zeros((B, N), dtype=torch.bool)
    mask[-1, N - N // 5:] = True
    return mask


def _heads_kw(H, dq, dv, **kw):
    return dict(num_heads=H, dq=dq, dv=dv, q_hs=dq, k_hs=dq, v_hs=dv, o_hs=dv,
                logit_scale=dq ** -0.5, **kw)


def _mha_case(dq, dv, Nq, Nk, probs=False, drop=0.0, qscale=False):
    """attention_reference as fused_mha calls it (the B4 shapes: 24 x 24
    encoder, 48 x 24 cross-attention, 48 x 48 class attention) against
    fused_mha's own plain version."""
    gen = torch.Generator().manual_seed(dq * 1000 + dv + Nq)
    B, H = 2, 2
    q, k, v = (_act(gen, B, Nq, H * dq), _act(gen, B, Nk, H * dq),
               _act(gen, B, Nk, H * dv))
    mask = _mask(B, Nk)
    kw = _heads_kw(H, dq, dv, kbias=key_bias(mask, B, Nk, "cpu"))
    q_in = q
    if qscale:   # the class attention's pre-scale: bf16(q * s) per column
        s = 1.0 + 0.1 * torch.randn((H, dq), generator=gen)
        kw["qscale"] = s
        q_in = (q.float() * s.reshape(1, 1, H * dq)).to(BF16)
    seed = torch.tensor([7], dtype=torch.int32)
    cd = CounterDropout(seed, attn=drop) if drop else None
    if drop:
        kw.update(drop=(SITE_MHA_ATTN, drop), seed=seed, mask_heads=H)
    want = fused_mha_train_reference(q_in, k, v, H, mask, cd,
                                     return_attn=probs)
    out = torch.empty((B, Nq, H * dv), dtype=BF16)
    got = {"out": out, "lse": torch.empty((B, H, Nq))}
    if probs:
        got["probs"] = torch.empty((B, H, Nq, Nk))
    K.attention_reference(q, k, v, out, lse=got["lse"], probs=got.get("probs"),
                          **kw)
    names = ("out", "probs", "lse") if probs else ("out", "lse")
    return got, dict(zip(names, want))


def _wl_fold_case():
    """attention_reference as the talking-heads block calls it at eval (the
    192 x 192 wl-fold: q, k and v shared by every head through a head
    stride of 0, q scaled per head, a head bias, f32 output) against
    softmax_attention on the heads written out."""
    gen = torch.Generator().manual_seed(192)
    B, H, N, D = 2, 3, 40, 192
    q, k, v = _act(gen, B, N, D), _act(gen, B, N, D), _act(gen, B, N, D)
    rows = 1.0 + 0.2 * torch.randn((H, D), generator=gen)
    hb = torch.randn((H,), generator=gen)
    out = torch.empty((B, N, H * D))
    lse = torch.empty((B, H, N))
    K.attention_reference(q, k, v, out, num_heads=H, dq=D, dv=D, q_hs=0,
                          k_hs=0, v_hs=0, o_hs=D, qscale=rows, hbias=hb,
                          logit_scale=D ** -0.5, lse=lse)
    qh = (q.float()[:, :, None, :] * rows).to(BF16).reshape(B, N, H * D)
    kh, vh = k.repeat(1, 1, H), v.repeat(1, 1, H)
    want_out, probs = softmax_attention(qh, kh, vh, H, return_attn=True)
    # a head bias is constant along each softmax row: it moves only the lse
    logits = torch.log(probs) + torch.logsumexp(
        torch.einsum("bnhd,bmhd->bhnm", qh.reshape(B, N, H, D).float(),
                     kh.reshape(B, N, H, D).float()) * D ** -0.5, -1)[..., None]
    want_lse = torch.logsumexp(logits, -1) + hb[None, :, None]
    return {"out": out.to(BF16), "lse": lse}, {"out": want_out,
                                               "lse": want_lse}


ATTENTION_CASES = {
    "24x24 encoder, key mask": lambda: _mha_case(24, 24, 37, 37),
    "24x24 encoder, dropout": lambda: _mha_case(24, 24, 37, 37, drop=0.1),
    "48x24 cross-attention, dropout": lambda: _mha_case(48, 24, 30, 45,
                                                        drop=0.1),
    "48x48 class attention, probabilities, q pre-scale": lambda: _mha_case(
        48, 48, 5, 26, probs=True, qscale=True),
    "192x192 talking-heads wl-fold": _wl_fold_case,
}


@pytest.mark.parametrize("case", list(ATTENTION_CASES))
def test_attention_reference_matches_plain(case):
    got, want = ATTENTION_CASES[case]()
    for name, w in want.items():
        tol = {"out": bf16_tol(w, ulps=1), "probs": 1e-6, "lse": 1e-5}[name]
        assert max_err(got[name], w) <= tol, name


LINEAR_CASES = linear_kernel_cases(device="cpu")


def _expected_linear(case):
    """{"out", "aux"} of one ln_linear call written out: F.layer_norm, A
    rounded to bf16, F.linear with the bias, the activation, the counter
    mask of (seed, site, m // rps, 0, m % rps, n), the DropPath factor of
    each sample, the residual and the column-group store."""
    a, w, kw = case["a"], case["w"], case["kw"]
    M, K = a.shape
    N = w.shape[0]
    x = a.float() + (kw["a2"].float() if "a2" in kw else 0.0)
    if "ln" in kw:
        x = F.layer_norm(x, (K,), kw["ln"][0], kw["ln"][1], kw["ln"][2])
    y = F.linear(x.to(BF16).float(), w.float(), kw["bias"])
    pre = y
    act = kw.get("act", "none")
    if act == "gelu":
        y = F.gelu(y, approximate="tanh")
    elif act == "relu":
        y = y.clamp_min(0.0)
    rps = kw.get("rows_per_sample", 1)
    if "drop" in kw:
        site, rate = kw["drop"]
        keep = counter_keep(kw["seed"], site, rate,
                            (M // rps, 1, rps, N)).reshape(M, N)
        y = torch.where(keep, y / (1.0 - rate), 0.0)
    want = {}
    if case["aux"] is not None:
        want["aux"] = pre if kw["aux_pre"] else y
    if "res" in kw:
        dp = torch.ones((M, 1))
        if "path" in kw:
            site, rate = kw["path"]
            dp = torch.where(path_keep(kw["seed"], site, rate, M // rps),
                             1.0 / (1.0 - rate), 0.0).repeat_interleave(
                                 rps)[:, None]
        y = kw["res"].float() + dp * kw.get("gamma", torch.ones(N)) * y
    if case["out"] is None:
        want["out"] = y.to(kw.get("out_dtype", BF16))
        return want
    dtype, numel, off, shape, stride = case["out"]
    out = torch.zeros(numel, dtype=dtype)
    grp, st = kw.get("col_group", N), kw.get("col_stride", N)
    n = torch.arange(N)
    rows = off + torch.arange(M)[:, None] * stride[0]
    out[rows + (n // grp * st + n % grp)] = y.to(dtype)
    want["out"] = out
    return want


@pytest.mark.parametrize("case", range(len(LINEAR_CASES)),
                         ids=[label for label, _ in LINEAR_CASES])
def test_ln_linear_reference_matches_torch(case):
    """ln_linear_reference writes exactly what the layer computes: f32
    outputs within 1e-5 of their largest magnitude (the bias added inside
    F.linear or after the product), bf16 outputs within one bf16 ulp (a
    sum on either side of a rounding boundary); the elements outside the
    column groups untouched."""
    _, c = LINEAR_CASES[case]
    got = linear_run(K.ln_linear_reference, c)
    want = _expected_linear(c)
    assert set(got) == set(want)
    for name, w in want.items():
        top = float(w.float().abs().max())
        tol = bf16_tol(w, ulps=1) if w.dtype == BF16 else 1e-5 * top
        assert top > 0, name
        assert got[name].dtype == w.dtype, name
        assert max_err(got[name], w) <= tol, name


TH_BWD_REF_CASES = {
    "H=4, dropout": (2, 4, 24, 0.1, False),
    "H=4, wl": (2, 4, 24, 0.0, True),
    "H=2, wl, dropout": (2, 2, 20, 0.1, True),
    "H=2": (1, 2, 16, 0.0, False),
}


@pytest.mark.parametrize("case", list(TH_BWD_REF_CASES))
def test_th_bwd_rows_reference_matches_autograd(case):
    """th_bwd_rows_reference against autograd in float64 through the plain
    talking-heads attention: m_g = sum_h wl[g, h] s_h + bl_g (without wl
    m = s + bl), p = softmax(m), z_g = sum_h ww[g, h] p_h + bw_g, the
    counter mask (seed, site, b, g, i, j) and 1 / (1 - rate), dzd the
    cotangent of the masked z. zd and ds (bf16) within one bf16 ulp at
    their largest magnitude; the parameter gradients (f32 sums over every
    element against float64) within 1e-4 of theirs, dbl (zero in exact
    arithmetic) within 1e-4 of dww's."""
    B, H, N, rate, wl = TH_BWD_REF_CASES[case]
    args, kw = th_bwd_case(B, H, N, rate, wl, device="cpu")
    s, _, dzd, bl, ww, bw, seed, _ = args
    got = K.th_bwd_rows_reference(*args, **kw)
    leaves = {n: t.double().requires_grad_() for n, t in
              (("s", s), ("bl", bl), ("ww", ww), ("bw", bw))}
    if wl:
        leaves["wl"] = kw["wl"].double().requires_grad_()
    m = leaves["s"]
    if wl:
        m = torch.einsum("bhqk,gh->bgqk", m, leaves["wl"])
    p = torch.softmax(m + leaves["bl"][None, :, None, None], -1)
    z = torch.einsum("bhqk,gh->bgqk", p, leaves["ww"]) + \
        leaves["bw"][None, :, None, None]
    if rate:
        z = torch.where(counter_keep(seed, kw["site"], rate, z.shape),
                        z / (1.0 - rate), 0.0)
    (z * dzd.double()).sum().backward()
    want = {"zd": z.detach(), "ds": leaves["s"].grad,
            "dww": leaves["ww"].grad, "dbw": leaves["bw"].grad,
            "dbl": leaves["bl"].grad}
    if wl:
        want["dwl"] = leaves["wl"].grad
    names = ("zd", "ds", "dww", "dbw", "dbl", "dwl")
    assert len(got) == len(want)
    for name, g in zip(names, got):
        w = want[name]
        if name in ("zd", "ds"):
            assert g.dtype == BF16, name
            tol = bf16_tol(w, ulps=1)
        else:
            tol = 1e-4 * float((want["dww"] if name == "dbl" else w)
                               .abs().max())
        assert max_err(g, w) <= tol, name


TH_FWD_REF_CASES = {
    "H=4, dropout": (2, 4, 24, 0.1, False),
    "H=4, wl": (2, 4, 24, 0.0, True),
    "H=2, wl, dropout": (2, 2, 20, 0.1, True),
    "H=2": (1, 2, 16, 0.0, False),
}


@pytest.mark.parametrize("case", list(TH_FWD_REF_CASES))
def test_th_fwd_rows_reference_matches_softmax(case):
    """th_fwd_rows_reference against the talking-heads softmax in float64:
    m_g = sum_h wl[g, h] s_h + bl_g (without wl m = s + bl), lse =
    logsumexp(m), z_g = sum_h ww[g, h] softmax(m)_h + bw_g, the counter
    mask (seed, site, b, g, i, j) and 1 / (1 - rate). lse within 1e-5 of
    its largest magnitude (f32 against float64), zd (bf16) within one bf16
    ulp at its largest."""
    B, H, N, rate, wl = TH_FWD_REF_CASES[case]
    args, kw = th_fwd_case(B, H, N, rate, wl, device="cpu")
    s, bl, ww, bw, seed, _ = args
    lse, zd = K.th_fwd_rows_reference(*args, **kw)
    m = s.double()
    if wl:
        m = torch.einsum("bhqk,gh->bgqk", m, kw["wl"].double())
    m = m + bl.double()[None, :, None, None]
    z = torch.einsum("bhqk,gh->bgqk", torch.softmax(m, -1), ww.double()) + \
        bw.double()[None, :, None, None]
    if rate:
        z = torch.where(counter_keep(seed, kw["site"], rate, z.shape),
                        z / (1.0 - rate), 0.0)
    want_lse = torch.logsumexp(m, -1)
    assert lse.dtype == torch.float32 and zd.dtype == BF16
    assert max_err(lse, want_lse) <= 1e-5 * float(want_lse.abs().max())
    assert max_err(zd, z) <= bf16_tol(z, ulps=1)


ATTN_ROWS_REF_CASES = {
    "key bias, dropout": (2, 2, 5, 24, True, 0.1, None),
    "mask_heads 4 of 2 x 2 heads, dropout": (4, 2, 6, 12, False, 0.1, 4),
    "key bias, no dropout": (1, 3, 4, 33, True, 0.0, None),
}


@pytest.mark.parametrize("case", list(ATTN_ROWS_REF_CASES))
def test_attention_bwd_rows_reference_matches_autograd(case):
    """attention_bwd_rows_reference against autograd in float64 through
    the masked softmax: p = softmax(s + kbias), z = M (.) p / (1 - rate)
    with the counter mask keyed (seed, site, z // mask_heads, z %
    mask_heads, i, j), dzd the cotangent of z. zd and dl (bf16) within one
    bf16 ulp at their largest magnitude."""
    B, H, Nq, Nk, kbias, rate, mask_heads = ATTN_ROWS_REF_CASES[case]
    args, kw = attn_rows_case(B, H, Nq, Nk, kbias, rate, mask_heads,
                              device="cpu")
    s, dzd, _, kb, seed, drop = args
    zd, dl = K.attention_bwd_rows_reference(*args, **kw)
    leaf = s.double().requires_grad_()
    m = leaf + (kb.double()[:, None, None, :] if kbias else 0.0)
    z = torch.softmax(m, -1)
    if rate:
        keep = counter_keep(seed, drop[0], rate, (B * H // (mask_heads or H),
                                                  mask_heads or H, Nq, Nk))
        z = torch.where(keep.reshape(z.shape), z / (1.0 - rate), 0.0)
    (z * dzd.double()).sum().backward()
    assert zd.dtype == BF16 and dl.dtype == BF16
    assert max_err(zd, z.detach()) <= bf16_tol(z.detach(), ulps=1)
    assert max_err(dl, leaf.grad) <= bf16_tol(leaf.grad, ulps=1)


COLSUM_REF_CASES = [(16, 1, 192), (1, 1, 13), (4, 7, 192), (16, 7, 13),
                    (2, 1025, 192), (16, 1025, 13)]


@pytest.mark.parametrize("B,N,C", COLSUM_REF_CASES)
def test_colsum_reference_matches_float64(B, N, C):
    """colsum_reference (f32 column sums of a strided bf16 view) against
    the float64 sum: each column within COLSUM_REL_TOL of its sum |v|."""
    v = colsum_case(B, N, C, C + 5, offset=3, device="cpu")
    got = K.colsum_reference(v)
    assert got.dtype == torch.float32 and got.shape == (B, C)
    assert colsum_err(got, v.double().sum(1), v) <= COLSUM_REL_TOL


@pytest.mark.parametrize("H", [1, 4, 8])
def test_th_fold_reference_is_one_rounding(H):
    """th_fold_reference on a strided q view (row stride 3D, as
    qkv3[..., :D]) equals the exact product (bf16 x f32 is exact in
    float64) rounded to f32 and then once to bf16, bit for bit, and so
    does torch.mul with a bf16 out= (the library call the smoke times)."""
    B, N, D = 3, 37, 48
    q, rows = th_fold_case(B, H, N, D, 3 * D, offset=5, device="cpu")
    got = K.th_fold_reference(q, rows)
    want = (q.double()[:, None] * rows.double()[None, :, None, :]).float()
    lib = torch.empty((B, H, N, D), dtype=BF16)
    torch.mul(q[:, None], rows[None, :, None, :], out=lib)
    assert got.dtype == BF16 and got.shape == (B, H, N, D)
    assert torch.equal(got, want.to(BF16))
    assert torch.equal(lib, got)


COLSUM_F32_REF_CASES = [(1, 1), (8, 192), (1001, 200), (4800, 256),
                        (777, 13)]


@pytest.mark.parametrize("M,C", COLSUM_F32_REF_CASES)
def test_colsum_f32_reference_matches_float64(M, C):
    """colsum_f32_reference (f32 column sums of a strided f32 view) against
    the float64 sum: each column within COLSUM_REL_TOL of its sum |x|."""
    x = colsum_f32_case(M, C, C + 3, offset=1, device="cpu")
    got = K.colsum_f32_reference(x)
    want = x.double().sum(0)
    scale = x.double().abs().sum(0).clamp_min(1e-30)
    assert got.dtype == torch.float32 and got.shape == (C,)
    assert float(((got.double() - want).abs() / scale).max()) <= COLSUM_REL_TOL


LN_BWD_REF_CASES = {
    "D=192, bf16 x and dx, residual": (192, True, True, True),
    "D=192, f32 x": (192, False, False, False),
    "D=192, f32 x, residual": (192, False, True, False),
    "D=256, bf16 x": (256, True, False, False),
    "D=256, f32 x, residual, bf16 dx": (256, False, True, True),
}


@pytest.mark.parametrize("case", list(LN_BWD_REF_CASES))
def test_ln_backward_reference_matches_autograd(case):
    """ln_backward_reference against float64 autograd of F.layer_norm (its
    input as the kernel reads it), plus the residual: f32 outputs within
    1e-5 of their largest magnitude, a bf16 dx within one bf16 ulp."""
    args, kw = ln_backward_case(37, *LN_BWD_REF_CASES[case], device="cpu")
    dy, x, w, eps = args
    dx, dw, db = K.ln_backward_reference(*args, **kw)
    xd = x.double().requires_grad_()
    wd = w.double().requires_grad_()
    bd = torch.zeros_like(wd, requires_grad=True)
    F.layer_norm(xd, (x.shape[1],), wd, bd, eps).backward(dy.double())
    want = xd.grad + (kw["res"].double() if "res" in kw else 0.0)
    assert dx.dtype == kw["out_dtype"] and dx.shape == x.shape
    tol = (bf16_tol(want, ulps=1) if dx.dtype == BF16
           else 1e-5 * float(want.abs().max()))
    assert max_err(dx, want) <= tol
    for got, ref in ((dw, wd.grad), (db, bd.grad)):
        assert got.dtype == torch.float32
        assert max_err(got, ref) <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("M,C", COLSUM_F32_MAIN)
def test_colsum_f32_plan_covers_once(M, C):
    """colsum_f32_plan at each class of the main path on an H100: the
    strips and the clusters' row runs cover every element once; strips of
    whole 16-byte units, at least COLSUM_F32_MIN_STRIP columns wide where
    the rows fill the clusters; a grid within one wave that puts a block on
    every SM there."""
    strip, cluster, run = K.colsum_f32_plan(M, C, H100_SMS)
    strips = -(-C // strip)
    count = torch.zeros((M, C), dtype=torch.int32)
    for s in range(strips):
        for k in range(cluster):
            count[k * run:(k + 1) * run, s * strip:(s + 1) * strip] += 1
    assert bool((count == 1).all())
    assert strip in K.COLSUM_F32_STRIPS and 1 <= cluster <= 16
    blocks = strips * cluster
    assert blocks <= H100_SMS * K.COLSUM_F32_BLOCKS_PER_SM
    if M >= max(K.COLSUM_F32_CLUSTERS) * K.COLSUM_F32_MIN_RUN:
        assert blocks >= H100_SMS and strip >= K.COLSUM_F32_MIN_STRIP


# a wave of ln_bwd_kernel on an H100 if only two blocks a SM fit, in
# clusters of 8 (ln_backward_wave asks the card)
LN_BWD_TEST_WAVE = H100_SMS * 2 // 8 * 8


@pytest.mark.parametrize("M,D", LN_BWD_MAIN)
def test_ln_backward_plan_covers_once(M, D):
    """ln_backward_plan at each class of the main path on an H100: the
    warps' row runs cover every row once; at most a wave of blocks; clusters
    of a power of two up to 8 blocks that divide the grid and the 2D
    columns; the workspace holds a row per cluster."""
    blocks, cluster, run = K.ln_backward_plan(M, LN_BWD_TEST_WAVE)
    count = torch.zeros(M, dtype=torch.int32)
    for w in range(blocks * K.LN_BWD_WARPS):
        count[min(M, w * run):min(M, (w + 1) * run)] += 1
    assert bool((count == 1).all())
    assert blocks <= LN_BWD_TEST_WAVE
    assert cluster in (1, 2, 4, 8) and blocks % cluster == 0
    assert (2 * D) % cluster == 0 and D in K.LN_BWD_WIDTHS
    assert blocks // cluster <= K.ln_backward_ws_rows(H100_SMS)


# (M, D, with val, with gamma, dropout, DropPath, rows per sample): every
# option on and off, M not a multiple of a block's run (1001), a few rows
BRANCH_BWD_REF_CASES = [
    (1001, 192, True, True, True, True, 77),
    (1001, 192, True, False, True, True, 77),
    (168, 192, True, True, False, False, 21),
    (3, 288, True, True, True, False, 1),
    (600, 100, False, False, True, False, 60),
    (256, 13, True, True, False, True, 16),
    (64, 768, False, True, False, True, 8),
]


@pytest.mark.parametrize("M,D,val,gamma,drop,path,rps", BRANCH_BWD_REF_CASES)
def test_branch_backward_reference_matches_float64(M, D, val, gamma, drop,
                                                   path, rps):
    """branch_backward_reference against the branch `x + dp * gamma *
    drop(y)` differentiated in float64: d = keep * dres * dp * gamma /
    (1 - rate) within 1e-5 of its largest magnitude, dgamma = sum dres *
    dp * val within COLSUM_REL_TOL of each column's sum of magnitudes; the
    masks are refmath's counter_keep (keyed by sample and row) and
    path_keep (by sample)."""
    (dres, v, g), kw = branch_backward_case(M, D, val, drop, path, rps,
                                            device="cpu")
    g = g if gamma else None
    d, dg = K.branch_backward_reference(dres, v, g, **kw)
    dp = torch.ones((M, 1), dtype=torch.float64)
    if path:
        site, rate = kw["path"]
        keep = path_keep(kw["seed"], site, rate, M // rps)
        dp = (keep.double() / (1 - rate)).repeat_interleave(rps)[:, None]
    want = dres.double() * dp * (g.double() if g is not None else 1.0)
    if drop:
        site, rate = kw["drop"]
        keep = counter_keep(kw["seed"], site, rate,
                            (M // rps, 1, rps, D)).reshape(M, D)
        want = torch.where(keep, want / (1 - rate), 0.0)
    assert d.dtype == torch.float32 and d.shape == (M, D)
    assert max_err(d, want) <= 1e-5 * float(want.abs().max())
    if not val:
        assert dg is None
        return
    terms = dres.double() * dp * v.double()
    scale = terms.abs().sum(0).clamp_min(1e-30)
    assert dg.dtype == torch.float32 and dg.shape == (D,)
    assert float(((dg.double() - terms.sum(0)).abs() / scale).max()) <= \
        COLSUM_REL_TOL


def _th_dq_numpy(dqt, q, rows, scale):
    """pallas_block.py:430-438 in float64 numpy, every row at once: dq~ =
    sum_g dqt_g * rows[g] and the dwl columns, stacked [h, g] as the TPU
    kernel stacks them."""
    B, H, N, D = dqt.shape
    dh = D // H
    qf = q.double().numpy().reshape(B * N, D)
    dq_t = np.zeros((B * N, D))
    cols = []
    for g in range(H):
        dqt_g = dqt[:, g].double().numpy().reshape(B * N, D)
        dq_t = dq_t + dqt_g * rows[g].double().numpy()
        qdq = qf * dqt_g
        cols.append(scale * np.stack(
            [np.sum(qdq[:, h * dh:(h + 1) * dh]) for h in range(H)]))
        del qdq
    return dq_t.reshape(B, N, D), np.stack(cols, axis=1)


@pytest.mark.parametrize("case", TH_DQ_SHAPES, ids=lambda c: c[0])
def test_th_dq_reference_matches_numpy(case):
    """th_dq_reference against float64 numpy of the TPU kernel's formula
    at every card-test shape with B <= 2 and N <= 40 (H = 1, 3, 4, 6, 8,
    16; q and out views of a (B, N, 3D) tensor or misaligned ones): dQ
    written into the out view only (the
    rest of its storage untouched) within 1e-5 of its largest magnitude,
    dwl in the torch Linear layout (the TPU kernel's [h, g] transposed)
    within 1e-5 of each entry's sum of magnitudes."""
    _, B, H, N, D, q_ld, o_ld, q_off, o_off = case
    B, N = min(B, 2), min(N, 40)
    dqt, q, rows, scale, out = th_dq_case(B, H, N, D, q_ld, o_ld, q_off,
                                          o_off, device="cpu")
    dwl = K.th_dq_reference(dqt, q, rows, scale, out)
    want_dq, want_hg = _th_dq_numpy(dqt, q, rows, scale)
    assert max_err(out, torch.from_numpy(want_dq)) <= \
        1e-5 * float(np.abs(want_dq).max())
    mask = torch.ones(storage_of(out).shape, dtype=torch.bool)
    mask.as_strided(out.shape, out.stride(), out.storage_offset()).fill_(False)
    assert bool(storage_of(out)[mask].isnan().all())
    qa = np.abs(q.double().numpy())[:, None]
    prod = qa * np.abs(dqt.double().numpy())                 # (B, H, N, D)
    dh = D // H
    mag = np.stack([prod[..., h * dh:(h + 1) * dh].sum((0, 2, 3))
                    for h in range(H)])                         # [h, g]
    want = torch.from_numpy(want_hg.T)
    assert dwl.dtype == torch.float32 and dwl.shape == (H, H)
    assert float(((dwl.double() - want).abs() /
                  torch.from_numpy(scale * mag.T).clamp_min(1e-30)).max()) \
        <= 1e-5


BRANCH_BWD_PLAN_CASES = sorted({(M, D) for _, M, D, *_ in BRANCH_BWD_SHAPES})


@pytest.mark.parametrize("M,D", BRANCH_BWD_PLAN_CASES)
def test_branch_backward_plan_covers_once(M, D):
    """branch_backward_plan at every class of the main path and the card
    tests' shapes on an H100: the strips and the clusters' row runs cover
    every element once; at most BRANCH_BWD_BLOCKS_PER_SM blocks a SM (one
    wave) at the main classes; a function of the shape alone."""
    strip, cluster, run = K.branch_backward_plan(M, D, H100_SMS)
    assert K.branch_backward_plan(M, D, H100_SMS) == (strip, cluster, run)
    strips = -(-D // strip)
    count = torch.zeros((M, D), dtype=torch.int32)
    for s in range(strips):
        for k in range(cluster):
            count[k * run:(k + 1) * run, s * strip:(s + 1) * strip] += 1
    assert bool((count == 1).all())
    assert strip in K.COLSUM_F32_STRIPS and 1 <= cluster <= 16
    if (M, D) in {(m, d) for m, d, *_ in BRANCH_BWD_MAIN}:
        assert strips * cluster <= H100_SMS * K.BRANCH_BWD_BLOCKS_PER_SM


TH_BWD_PLAN_CASES = sorted({(B, H, N, wl) for _, B, H, N, _, wl in
                            TH_BWD_SHAPES} | set(TH_BWD_MAIN))


@pytest.mark.parametrize("B,H,N,wl", TH_BWD_PLAN_CASES)
def test_th_bwd_scratch_covers_once(B, H, N, wl):
    """th_bwd_rows_kernel's one-wave grid at the main path's classes and the
    card tests' shapes, for a wave of one and two blocks a SM on an H100
    and for the most blocks: the blocks' row runs cover every (sample,
    query) row once, at most a wave of blocks, each block's sums a row of
    the scratch (blocks x width within TH_BLOCKS x TH_BWD_MAX_WIDTH, so
    every H the kernel takes fits); a function of the shape and the
    wave."""
    rows = B * N
    width = (2 if wl else 1) * H * H + 2 * H
    assert width <= K.TH_BWD_MAX_WIDTH
    for wave in (H100_SMS, 2 * H100_SMS, K.TH_BLOCKS):
        blocks = K.th_bwd_blocks(B, N, wave)
        assert K.th_bwd_blocks(B, N, wave) == blocks
        per = -(-rows // wave)
        count = torch.zeros(rows, dtype=torch.int32)
        for k in range(blocks):
            count[k * per:(k + 1) * per] += 1
        assert bool((count == 1).all())
        assert 1 <= blocks <= wave
        assert blocks * width <= K.TH_BLOCKS * K.TH_BWD_MAX_WIDTH
        if (B, H, N, wl) in TH_BWD_MAIN:
            assert blocks > wave - per


TH_DQ_PLAN_CASES = sorted({c[1:5] for c in TH_DQ_SHAPES} | set(TH_DQ_MAIN))


@pytest.mark.parametrize("B,H,N,D", TH_DQ_PLAN_CASES)
def test_th_dq_plan_covers_once(B, H, N, D):
    """th_dq_plan at the main path's class and the card tests' shapes on an
    H100: the blocks' row runs, split over a block's row slots, cover every
    row once, and a row's chunks over the passes cover every column once,
    each chunk in one head; at most TH_DQ_BLOCKS_PER_SM blocks a SM (one
    wave); the workspace holds a (H, H) row per block; a function of the
    shape alone."""
    group, blocks, run = K.th_dq_plan(B, N, H, D, H100_SMS)
    assert K.th_dq_plan(B, N, H, D, H100_SMS) == (group, blocks, run)
    rows, slots = B * N, K.TH_DQ_NT // group
    assert 1 <= group <= K.TH_DQ_NT and slots >= 1
    count = torch.zeros(rows, dtype=torch.int32)
    for k in range(blocks):
        m0, m1 = min(rows, k * run), min(rows, (k + 1) * run)
        for r in range(slots):
            count[m0 + r:m1:slots] += 1
    assert bool((count == 1).all())
    V = K.th_dq_chunk(D, H)
    chunks, dh = D // V, D // H
    assert chunks * V == D and dh % V == 0
    cover = torch.zeros(D, dtype=torch.int32)
    for j0 in range(0, chunks, group):
        for t in range(group):
            if j0 + t < chunks:
                cover[(j0 + t) * V:(j0 + t + 1) * V] += 1
                assert ((j0 + t) * V) // dh == ((j0 + t + 1) * V - 1) // dh
    assert bool((cover == 1).all())
    assert blocks <= H100_SMS * K.TH_DQ_BLOCKS_PER_SM
    assert blocks * H * H <= H100_SMS * K.TH_DQ_BLOCKS_PER_SM * K.TH_DQ_NT


# (M, D, x bf16, eps, row stride, storage offset): bf16 and f32 rows at
# both eps, the widths of the registered backbones, a strided view
LN_REF_CASES = [(64, 192, True, 1e-6, 192, 0), (64, 192, False, 1e-5, 192, 0),
                (33, 768, True, 1e-5, 768, 0), (21, 288, False, 1e-6, 288, 0),
                (17, 13, False, 1e-6, 13, 0), (40, 192, True, 1e-5, 577, 1)]


@pytest.mark.parametrize("M,D,x_bf16,eps,ld,off", LN_REF_CASES)
def test_layernorm_reference_matches_float64(M, D, x_bf16, eps, ld, off):
    """layernorm_reference against float64 numpy of the TPU kernels'
    _ln_fwd (spe_tpu/ops/pallas_block.py:63: the mean, then the centred
    variance): the f32 output within 1e-5 of its largest magnitude, the
    bf16 one within one bf16 ulp."""
    (x, w, b, _), kw = layernorm_case(M, D, x_bf16, True, True, eps, ld, off,
                                      device="cpu")
    y32, y16 = K.layernorm_reference(x, w, b, eps, **kw)
    xf = x.double().numpy()
    mu = xf.mean(-1, keepdims=True)
    xc = xf - mu
    var = (xc * xc).mean(-1, keepdims=True)
    want = torch.from_numpy(xc / np.sqrt(var + eps) * w.double().numpy()
                            + b.double().numpy())
    assert y32.dtype == torch.float32 and y16.dtype == BF16
    assert y32.shape == y16.shape == (M, D)
    assert max_err(y32, want) <= 1e-5 * float(want.abs().max())
    assert max_err(y16, want) <= bf16_tol(want, ulps=1)
    assert K.layernorm_reference(x, w, b, eps, want_f32=False)[0] is None


# (B, N, H, dh): the recipe's heads of 48 and narrow ones
TH_MIX_REF_CASES = [(2, 16, 4, 48), (1, 9, 3, 8), (3, 5, 1, 16),
                    (1, 12, 6, 48)]


@pytest.mark.parametrize("B,N,H,dh", TH_MIX_REF_CASES)
def test_th_mix_reference_matches_tpu_mix(B, N, H, dh):
    """th_mix_reference against float64 numpy of the TPU kernel's
    post-softmax mix (spe_tpu/ops/pallas_block.py:143-148): z_g = sum_h
    ww[h, g] P_h + bw_g, out_g = z_g V_g, with P real softmax rows; the
    port's operands are P_g V per head g, the column sums of V and ww in
    the JAX layout transposed as models/convert.py does. Within one bf16
    ulp at the largest magnitude."""
    from spe_tpu_torch.models.convert import _t

    rng = np.random.default_rng(100 * B + 10 * N + H)
    D = H * dh
    logits = 2.0 * rng.standard_normal((B, H, N, N))
    P = np.exp(logits - logits.max(-1, keepdims=True))
    P /= P.sum(-1, keepdims=True)
    V = rng.standard_normal((B, N, D))
    ww_jax = rng.standard_normal((H, H))
    bw = 0.1 * rng.standard_normal(H)
    want = np.zeros((B, N, D))
    for g in range(H):
        z = sum(P[:, h] * ww_jax[h, g] for h in range(H)) + bw[g]
        cols = slice(g * dh, (g + 1) * dh)
        want[..., cols] = z @ V[..., cols]
    pv = torch.from_numpy(np.einsum("bgnm,bmc->bngc", P, V)).float()
    csum = torch.from_numpy(V.sum(1)).float()
    got = K.th_mix_reference(pv.contiguous(), csum, _t(ww_jax),
                             torch.from_numpy(bw).float())
    want = torch.from_numpy(want)
    assert got.dtype == BF16 and got.shape == (B, N, D)
    assert max_err(got, want) <= bf16_tol(want, ulps=1)


# one wave of blocks at a few occupancies (the card's query decides it)
PLAN_WAVES = [H100_SMS * k for k in (2, 3, 4)]


@pytest.mark.parametrize("wave", PLAN_WAVES)
@pytest.mark.parametrize("M", sorted({c[0] for c in LAYERNORM_MAIN}))
def test_layernorm_plan_covers_once(M, wave):
    """layernorm_plan at each row count the main path gives it: the warps'
    runs cover every row once, within one wave of blocks."""
    blocks, run = K.layernorm_plan(M, wave)
    assert K.layernorm_plan(M, wave) == (blocks, run)
    count = torch.zeros(M, dtype=torch.int32)
    for w in range(blocks * K.LAYERNORM_NT // 32):
        count[min(M, w * run):min(M, (w + 1) * run)] += 1
    assert bool((count == 1).all())
    assert blocks <= wave and run >= 1


TH_MIX_PLAN_CASES = sorted({(B * N, D) for _, B, N, H, D in TH_MIX_SHAPES})


@pytest.mark.parametrize("wave", PLAN_WAVES)
@pytest.mark.parametrize("rows,D", TH_MIX_PLAN_CASES)
def test_th_mix_plan_covers_once(rows, D, wave):
    """th_mix_plan at the main path's class and the card tests' shapes:
    the threads' (unit of 8 columns, run of rows) pairs cover every unit of
    every row once, within one wave of blocks."""
    blocks, run = K.th_mix_plan(rows, D, wave)
    units = D // 8
    t = torch.arange(blocks * K.TH_MIX_NT)
    slot, u = t // units, t % units
    count = torch.zeros((rows, units), dtype=torch.int32)
    for k in range(run):
        r = slot * run + k
        live = r < rows
        count.index_put_((r[live], u[live]),
                         torch.ones(int(live.sum()), dtype=torch.int32),
                         accumulate=True)
    assert bool((count == 1).all())
    assert blocks <= wave
