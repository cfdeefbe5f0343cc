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
masked softmax with its key bias and dropout. No JAX
here: the reference functions it is held to are the port's own plain
versions and torch's.

f32 outputs are held to 1e-5 of their largest magnitude (f32 sums against
float64 ones, over bf16-rounded operands whose products are exact in
f32); bf16 outputs to one bf16 ulp at their largest magnitude (a sum on
either side of a rounding boundary)."""

import pytest
import torch
import torch.nn.functional as F

from spe_tpu_torch.ops import kernels as K
from spe_tpu_torch.ops.fused_encoder import softmax_attention
from spe_tpu_torch.ops.fused_mha import (fused_mha_reference,
                                         fused_mha_train_reference)
from spe_tpu_torch.ops.kernel_checks import (attn_rows_case, bf16_tol,
                                             gemm_kernel_cases, gemm_run,
                                             linear_kernel_cases, linear_run,
                                             max_err, storage_of, th_bwd_case,
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
