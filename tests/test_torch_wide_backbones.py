"""The wider backbones' shapes on the CPU, held against the JAX package:
the XS24/S/M forms' talking heads at H = 6 and H = 16 (tiny blocks, dh =
8), the encoder and decoder layers at dt = 36 and 96 (d_model 288 and
768, XS24's and the M backbones'), the plain versions of ln_backward at
D = 288, 384 and 768, and of the talking-heads row passes at H = 16 and
at N = 1600 (the 640 x 640 bucket's patches). On the CPU every autograd
Function takes its plain version (the CUDA kernels' oracle on the card);
the JAX side runs its Pallas kernels in interpret mode, each JAX
computation one jitted call finished before anything else is dispatched
(`_sync`). Tolerances are the JAX package's: blocks and talking heads 2e-4
(dx) and 3e-4 (parameters), the encoder 3e-4, the decoder 5e-4; the row
passes' bf16 outputs within 2^-8 of their largest magnitude (the plain
version rounds zd and ds to bf16 as the kernels store them) and their f32
sums, over up to 2.56M terms in other orders, within 1e-4 of theirs;
ln_backward within 1e-5."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spe_tpu.models.cait import LayerScaleBlock
from spe_tpu.models.transformer import (ConditionalDecoderLayer,
                                        TransformerEncoderLayer)
from spe_tpu.ops.pallas_attention import talking_heads_attention as jax_th
from spe_tpu.ops.pallas_attention import talking_heads_reference
from spe_tpu.ops.pallas_attention_bwd import fused_talking_heads
from spe_tpu.ops.pallas_block import _ln_bwd, _ln_fwd
from spe_tpu.ops.pallas_block import fused_layer_scale_block as jax_block
from spe_tpu.ops.pallas_decoder import fused_decoder_layer as jax_dec
from spe_tpu.ops.pallas_encoder import fused_encoder_layer as jax_enc
from spe_tpu_torch.models.convert import (block_state_dict,
                                          decoder_layer_state_dict,
                                          encoder_layer_state_dict)
from spe_tpu_torch.ops import (fused_block, fused_decoder, fused_encoder,
                               kernels, talking_heads)
# the fused layers' CUDA paths on the CPU, every kernel wrapper replaced by
# its plain version
from test_torch_cuda_glue import emulated  # noqa: F401

B = 2


def _sync(fn, *args):
    """fn(*args) as one jitted JAX call, waited for before anything else is
    dispatched (the Pallas interpreter's io_callbacks dispatch JAX work of
    their own: an eager dispatch meanwhile can deadlock, ROADMAP §C)."""
    return jax.block_until_ready(jax.jit(fn)(*args))


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, tol, msg):
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol,
                               err_msg=msg)


def _near_one(params, rng):
    """LayerScale gammas and LayerNorm scales near 1, LayerNorm biases
    small and nonzero, so every branch shows."""
    flat = flax.traverse_util.flatten_dict(params)
    for k, v in flat.items():
        if k[-1] in ("gamma_1", "gamma_2", "scale"):
            flat[k] = jnp.asarray(1.0 + 0.1 * rng.normal(size=v.shape),
                                  jnp.float32)
        elif k[-1] == "bias" and len(k) >= 2 and k[-2].startswith("norm"):
            flat[k] = jnp.asarray(0.05 * rng.normal(size=v.shape), jnp.float32)
    return flax.traverse_util.unflatten_dict(flat)


def _row(a):
    return jnp.asarray(a).reshape(1, -1)


def _leaves(sd):
    return {k: v.detach().clone().requires_grad_() for k, v in sd.items()}


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------- patch blocks

def _block_kernel_params(p, H):
    a = p["attn"]
    return (_row(p["norm1"]["scale"]), _row(p["norm1"]["bias"]),
            a["qkv"]["kernel"], _row(a["qkv"]["bias"]), a["proj_l"],
            a["proj_l_bias"].reshape(H, 1), a["proj_w"],
            a["proj_w_bias"].reshape(H, 1), a["proj"]["kernel"],
            _row(a["proj"]["bias"]), _row(p["gamma_1"]),
            _row(p["norm2"]["scale"]), _row(p["norm2"]["bias"]),
            p["mlp"]["fc1"]["kernel"], _row(p["mlp"]["fc1"]["bias"]),
            p["mlp"]["fc2"]["kernel"], _row(p["mlp"]["fc2"]["bias"]),
            _row(p["gamma_2"]), jnp.zeros((1,), jnp.float32))


# (heads, batch): XS24's 6 and the M backbones' 16 heads, of dh = 8; one
# image at 16 heads (the interpreted kernels' cost grows with the heads)
HEADS = pytest.mark.parametrize("H,Bh", [(6, 2), (16, 1)],
                                ids=["H6 (XS24)", "H16 (M36/M48)"])


@HEADS
def test_fused_block_forward_and_vjp_match_jax(rng, H, Bh):
    """The fused patch block (the port's Function, plain on the CPU) at
    H heads of dh = 8: its output against fused_layer_scale_block's
    forward, and its VJP against jax.grad through the Pallas kernels."""
    N, dh = 16, 8
    D = H * dh
    x = rng.normal(size=(Bh, N, D)).astype(np.float32)
    blk = LayerScaleBlock(num_heads=H, init_scale=1.0)
    params = _near_one(_sync(lambda x: blk.init(jax.random.PRNGKey(0), x),
                             jnp.asarray(x))["params"], rng)

    def fwd(p, x):
        return jax_block(x, _block_kernel_params(p, H), 16, True, 0.0, 0.0,
                         0.0)

    def fwd_vjp(p, x):   # the output and the VJP of sum(sin(y)), one trace
        y, vjp = jax.vjp(fwd, p, x)
        return y, vjp(jnp.cos(y))

    y, (gp, gx) = _sync(fwd_vjp, params, jnp.asarray(x))
    want = block_state_dict(_tree_np(gp))
    sd = _leaves(block_state_dict(_tree_np(params)))
    with torch.no_grad():
        out = fused_block.fused_layer_scale_block(_t(x), sd, H)
    _close(_np(out), y, 2e-4, "y")
    xt = _t(x).requires_grad_()
    torch.sin(fused_block.fused_layer_scale_block(xt, sd, H)).sum().backward()
    _close(_np(xt.grad), gx, 2e-4, "dx")
    for k in fused_block.PARAM_NAMES:
        _close(_np(sd[k].grad), want[k], 3e-4, k)


def _flat(x):
    """(B, H, N, d) -> the port's (B, N, H*d)."""
    b, h, n, d = x.shape
    return np.ascontiguousarray(np.transpose(x, (0, 2, 1, 3)).reshape(
        b, n, h * d))


@HEADS
def test_talking_heads_forward_and_vjp_match_jax(rng, H, Bh):
    """The standalone talking-heads attention (use_pallas_attention with the
    fused block off) at H heads of dh = 8: the plain forward against
    talking_heads_attention (interpret mode), the Function's gradients
    against fused_talking_heads' VJP (interpret mode, rate 0) at 6 heads
    and against the VJP of the JAX package's einsum path at 16
    (talking_heads_reference, which tests/test_pallas_attention.py holds
    the kernels to: the interpreted backward kernel alone takes ~15 s to
    compile at 16 heads)."""
    N, dh = 8, 8
    q, k, v = (rng.normal(size=(Bh, H, N, dh)).astype(np.float32)
               for _ in range(3))
    wl, ww = ((np.eye(H) + 0.3 * rng.normal(size=(H, H))).astype(np.float32)
              for _ in range(2))
    bl, bw = (0.1 * rng.normal(size=(H,)).astype(np.float32)
              for _ in range(2))
    ins = tuple(jnp.asarray(a) for a in (q, k, v, wl, bl, ww, bw))

    def fwd_vjp(*a):   # fused_talking_heads' forward is talking_heads_attention
        if H <= 8:
            y, vjp = jax.vjp(lambda *a: fused_talking_heads(
                *a, None, N, True, 0.0), *a)
            return y, vjp(jnp.cos(y))
        y = jax_th(*a, q_tile=N, interpret=True)
        y_ref, vjp = jax.vjp(talking_heads_reference, *a)
        return y, vjp(jnp.cos(y_ref))

    y, grads = _sync(fwd_vjp, *ins)
    # the port's mixing matrices are the torch Linear layout: transposed
    p = {"proj_l.weight": _t(wl.T), "proj_l.bias": _t(bl),
         "proj_w.weight": _t(ww.T), "proj_w.bias": _t(bw)}
    got = talking_heads.talking_heads_reference(
        _t(_flat(q)), _t(_flat(k)), _t(_flat(v)), p, H)
    _close(_np(got), _flat(np.asarray(y)), 2e-4, "y")
    leaves = [_t(_flat(a)).requires_grad_() for a in (q, k, v)]
    p = {n: t.requires_grad_() for n, t in p.items()}
    torch.sin(talking_heads.talking_heads_attention(*leaves, p, H)).sum() \
        .backward()
    for name, t, w in zip("qkv", leaves, grads[:3]):
        _close(_np(t.grad), _flat(np.asarray(w)), 2e-4, f"d{name}")
    for name, w, transpose in (("proj_l.weight", grads[3], True),
                               ("proj_l.bias", grads[4], False),
                               ("proj_w.weight", grads[5], True),
                               ("proj_w.bias", grads[6], False)):
        w = np.asarray(w)
        _close(_np(p[name].grad), w.T if transpose else w, 3e-4, name)


# ---------------------------------------------------- encoder and decoder

def _mask(n):
    """Key-padding mask: none padded on image 0, the last 5 on image 1."""
    return np.arange(n)[None, :] >= np.array([[n], [n - 5]])


def _bias(mask):
    return jnp.asarray(np.where(mask, -1e9, 0.0).astype(np.float32)[:, None, :])


# d_model with 8 heads: dt = 36 (XS24) and 96 (M36/M48)
WIDTHS = pytest.mark.parametrize("D", [288, 768], ids=["dt36", "dt96"])
NHEADS = 8


@WIDTHS
def test_encoder_layer_vjp_matches_jax(rng, D):
    """The fused encoder layer at d_model D, 8 heads of dt = D / 8: its
    gradients (x, pos and every parameter) against jax.grad through
    fused_encoder_layer (interpret mode, rate 0), 3e-4."""
    N, F = 16, 32
    x, pos = (rng.normal(size=(B, N, D)).astype(np.float32) for _ in range(2))
    mask = _mask(N)
    layer = TransformerEncoderLayer(NHEADS, F, dropout=0.1)
    params = _near_one(_sync(lambda x, pos: layer.init(
        jax.random.PRNGKey(0), x, pos), jnp.asarray(x),
        jnp.asarray(pos))["params"], rng)

    def kernel_params(p):
        sa = p["self_attn"]
        return tuple(
            v for n in ("q_proj", "k_proj", "v_proj", "out_proj")
            for v in (sa[n]["kernel"], _row(sa[n]["bias"]))) + (
            _row(p["norm1"]["scale"]), _row(p["norm1"]["bias"]),
            p["linear1"]["kernel"], _row(p["linear1"]["bias"]),
            p["linear2"]["kernel"], _row(p["linear2"]["bias"]),
            _row(p["norm2"]["scale"]), _row(p["norm2"]["bias"]),
            _bias(mask), jnp.zeros((1,), jnp.float32))

    def loss(p, x, pos):
        return jnp.sum(jnp.sin(jax_enc(x, pos, kernel_params(p), NHEADS,
                                       True, 0.0)))

    gp, gx, gpos = _sync(jax.grad(loss, argnums=(0, 1, 2)), params,
                         jnp.asarray(x), jnp.asarray(pos))
    want = encoder_layer_state_dict(_tree_np(gp))
    sd = _leaves(encoder_layer_state_dict(_tree_np(params)))
    xt, pt = _t(x).requires_grad_(), _t(pos).requires_grad_()
    out = fused_encoder.fused_encoder_layer(xt, pt, torch.from_numpy(mask),
                                            sd, NHEADS)
    torch.sin(out).sum().backward()
    _close(_np(xt.grad), gx, 3e-4, "dx")
    _close(_np(pt.grad), gpos, 3e-4, "dpos")
    for k in fused_encoder.PARAM_NAMES:
        _close(_np(sd[k].grad), want[k], 3e-4, k)


def _decoder_kernel_params(p):
    def dense(n):
        return p[n]["kernel"], _row(p[n]["bias"])

    ps = [v for n in ("sa_qcontent_proj", "sa_qpos_proj", "sa_kcontent_proj",
                      "sa_kpos_proj", "sa_v_proj") for v in dense(n)]
    ps += [p["self_attn"]["out_proj"]["kernel"],
           _row(p["self_attn"]["out_proj"]["bias"]),
           _row(p["norm1"]["scale"]), _row(p["norm1"]["bias"])]
    for n in ("ca_qcontent_proj", "ca_kcontent_proj", "ca_v_proj",
              "ca_kpos_proj", "ca_qpos_proj", "ca_qpos_sine_proj"):
        ps += list(dense(n))
    ps += [p["cross_attn"]["out_proj"]["kernel"],
           _row(p["cross_attn"]["out_proj"]["bias"]),
           _row(p["norm2"]["scale"]), _row(p["norm2"]["bias"]),
           *dense("linear1"), *dense("linear2"),
           _row(p["norm3"]["scale"]), _row(p["norm3"]["bias"])]
    return tuple(ps)


@WIDTHS
def test_decoder_layer_vjp_matches_jax(rng, D):
    """The fused decoder's first layer (with ca_qpos_proj) at d_model D:
    self-attention dt x dt, the conditional cross-attention 2dt x dt; its
    gradients against jax.grad through fused_decoder_layer (interpret
    mode, rate 0), 5e-4."""
    S, Q, N, F = 2, 4, 12, 32
    tgt, qpos, sine = (rng.normal(size=(B, S * Q, D)).astype(np.float32)
                       for _ in range(3))
    mem, pos = (rng.normal(size=(B, N, D)).astype(np.float32) for _ in range(2))
    mask = _mask(N)
    layer = ConditionalDecoderLayer(NHEADS, F, dropout=0.1, num_sets=S)
    args = [jnp.asarray(a) for a in (tgt, mem, pos, qpos, sine)]
    params = _near_one(_sync(lambda *a: layer.init(
        jax.random.PRNGKey(0), *a, is_first=True), *args)["params"], rng)
    extra = (_bias(mask), jnp.zeros((1, Q), jnp.float32),
             jnp.zeros((1,), jnp.float32))

    def loss(p, *xs):
        y = jax_dec(*xs, NHEADS, S, True, 0.0,
                    _decoder_kernel_params(p) + extra)
        return jnp.sum(jnp.sin(y))

    grads = _sync(jax.grad(loss, argnums=tuple(range(6))), params, *args)
    want = decoder_layer_state_dict(_tree_np(grads[0]))
    sd = _leaves(decoder_layer_state_dict(_tree_np(params)))
    ins = [_t(a).requires_grad_() for a in (tgt, mem, pos, qpos, sine)]
    out = fused_decoder.fused_decoder_layer(*ins, torch.from_numpy(mask), sd,
                                            NHEADS, S)
    torch.sin(out).sum().backward()
    for name, t, g in zip(("dtgt", "dmem", "dpos", "dqpos", "dsine"), ins,
                          grads[1:]):
        _close(_np(t.grad), g, 5e-4, name)
    for k in want:
        _close(_np(sd[k].grad), want[k], 5e-4, k)


# ------------------------------------------------- the kernels' plain versions

def _rel(got, want, rel, msg):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    tol = rel * float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= tol, msg


@pytest.mark.parametrize("D", [288, 384, 768])
def test_ln_backward_plain_matches_jax(rng, D):
    """kernels.ln_backward_reference (ln_bwd_kernel's plain version) at
    every new width against the TPU kernels' LayerNorm backward
    (pallas_block.py _ln_fwd/_ln_bwd), 1e-5 of each output's largest."""
    M = 40
    x = (0.5 + 2.0 * rng.normal(size=(M, D))).astype(np.float32)
    dy = (1e-2 * rng.normal(size=(M, D))).astype(np.float32)
    g = (1.0 + 0.1 * rng.normal(size=(D,))).astype(np.float32)
    b = np.zeros(D, np.float32)

    def jax_bwd(dy, x, g, b):
        _, xhat, inv = _ln_fwd(x, g, b)
        return _ln_bwd(dy, xhat, inv, g)

    want = _sync(jax_bwd, *(jnp.asarray(a) for a in (dy, x, g, b)))
    got = kernels.ln_backward_reference(_t(dy), _t(x), _t(g), 1e-6)
    for name, gv, wv in zip(("dx", "dweight", "dbias"), got, want):
        _rel(_np(gv), wv, 1e-5, name)


# the row passes' parameter gradients: f32 sums over B * N^2 (up to 2.56M)
# terms, taken in other orders by the two frameworks
SUM_TOL = 1e-4


def _identity_heads(s, H, N):
    """q, k, v for talking_heads_reference whose logits are s and whose
    output is the mixed probabilities themselves: dh = N, k = v = I, q =
    s * sqrt(N) (the reference scales q by dh^-0.5)."""
    eye = np.broadcast_to(np.eye(N, dtype=np.float32), (1, H, N, N))
    return s * np.float32(np.sqrt(N)), eye, eye


@pytest.mark.parametrize("H,N,wl", [(16, 64, True), (16, 64, False),
                                    (2, 1600, True)],
                         ids=["H16 wl", "H16 (the fused block's)", "N1600 wl"])
def test_th_rows_plain_match_jax(rng, one_thread, H, N, wl):
    """th_fwd_rows_reference and th_bwd_rows_reference (the row passes'
    plain versions, rate 0) at 16 heads and at 1600 keys against
    talking_heads_reference and its jax.vjp (the standalone attention's
    math; the fused block's form, logits already mixed, is its wl = I): zd
    against the mixed probabilities, ds against dL_h = dq sqrt(dh), the
    mixes' and biases' gradients; with k = v = I the reference's output is
    z itself, so the cotangent dzd is z's."""
    s = (2.0 * rng.normal(size=(1, H, N, N))).astype(np.float32)
    dzd = (1e-2 * rng.normal(size=(1, H, N, N))).astype(np.float32)
    eye = np.eye(H, dtype=np.float32)
    wl_p = (eye + 0.2 * rng.normal(size=(H, H))).astype(np.float32) if wl \
        else eye
    ww_p = (eye + 0.2 * rng.normal(size=(H, H))).astype(np.float32)
    bl, bw = (0.1 * rng.normal(size=(H,)).astype(np.float32)
              for _ in range(2))
    q, k, v = _identity_heads(s, H, N)

    def jax_rows(q, k, v, wl, bl, ww, bw, dz):
        # the JAX layout of the mixes is (in x out): the port's transposed
        z, vjp = jax.vjp(lambda q, wl, bl, ww, bw: talking_heads_reference(
            q, k, v, wl, bl, ww, bw), q, wl, bl, ww, bw)
        return z, vjp(dz)

    z, (dq, dwl, dbl, dww, dbw) = _sync(
        jax_rows, *(jnp.asarray(a) for a in (q, k, v, wl_p.T, bl, ww_p.T, bw,
                                             dzd)))
    seed = torch.zeros((1,), dtype=torch.int32)
    kw = dict(wl=_t(wl_p)) if wl else {}
    args = (_t(bl), _t(ww_p), _t(bw), seed, 0.0)
    lse, zd = kernels.th_fwd_rows_reference(_t(s), *args, **kw)
    _rel(_np(zd), z, 2.0 ** -8, "zd")
    out = kernels.th_bwd_rows_reference(_t(s), lse, _t(dzd), *args, **kw)
    _rel(_np(out[0]), z, 2.0 ** -8, "zd (backward)")
    _rel(_np(out[1]), np.asarray(dq) * np.sqrt(N), 2.0 ** -8, "ds")
    _rel(_np(out[2]), np.asarray(dww).T, SUM_TOL, "dww")
    _rel(_np(out[3]), dbw, SUM_TOL, "dbw")
    # dbl, zero in exact arithmetic (rows of a softmax backward), against
    # the mix's gradient
    tol = SUM_TOL * float(np.abs(np.asarray(dww)).max())
    assert float(np.abs(_np(out[4]) - np.asarray(dbl)).max()) <= tol, "dbl"
    if wl:
        _rel(_np(out[5]), np.asarray(dwl).T, SUM_TOL, "dwl")


@pytest.fixture
def one_thread():
    """torch on one thread: the plain row passes' planes are small, and a
    thread pool would spin against the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------ the CUDA glue at the wide widths

# XS24's and the M backbones' widths and heads (the transformer's 8 heads
# of dt = 36 and 96)
WIDE = [(288, 6), (768, 16)]


@pytest.mark.parametrize("case", range(5))
@pytest.mark.parametrize("D,H", WIDE, ids=["XS24", "M"])
def test_wide_cuda_path_wiring(emulated, one_thread, D, H, case):
    """Each fused layer's eval CUDA path at a wide backbone's widths, its
    wrappers emulated: the patch block wider than the D x D attention
    forms through its training kernels at rate 0 (th_fold, the logits
    product, th_fwd_rows, zd . V), the class attention at dh = 48, the
    encoder and the decoder (both parameter sets) at dt = D / 8, against
    the plain versions within 2 bf16 ulps (the class-attention
    probabilities within PROBS_TOL, the card's: at D = 768 the emulated
    and the plain q projections round 1e-5 apart)."""
    from spe_tpu_torch.ops.kernel_checks import (PROBS_TOL, bf16_tol,
                                                 kernel_cases, max_err)

    name, _, fused, plain, args = kernel_cases(B=1, N=40, t=5, Q=6,
                                               device="cpu", D=D, H=H)[case]
    mod = __import__(fused.__module__, fromlist=["_forward_cuda"])
    with torch.no_grad():
        got = mod._forward_cuda(*args)
        want = plain(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert max_err(got[0], want[0]) <= bf16_tol(want[0], ulps=2), name
    for g, w in zip(got[1:], want[1:]):
        assert max_err(g, w) <= PROBS_TOL, name


@pytest.mark.parametrize("D,H", WIDE, ids=["XS24", "M"])
def test_wide_block_eval_takes_the_training_kernels(emulated, monkeypatch,
                                                    D, H):
    """A patch block wider than XXS's evaluates through th_fwd_rows (no
    D x D attention form exists), one call a block, and never calls the
    attention kernel or th_mix."""
    from spe_tpu_torch.ops.kernel_checks import kernel_cases

    calls = []
    for name in ("attention", "th_mix", "th_fwd_rows", "th_fold"):
        ref = getattr(kernels, f"{name}_reference")
        monkeypatch.setattr(kernels, name, lambda *a, _n=name, _r=ref, **k: (
            calls.append(_n), _r(*a, **k))[1])
    _, _, _, _, args = kernel_cases(B=1, N=40, t=5, Q=6, device="cpu", D=D,
                                    H=H)[0]
    with torch.no_grad():
        fused_block._forward_cuda(*args)
    assert sorted(calls) == ["th_fold", "th_fwd_rows"]


@pytest.mark.parametrize("case", range(5))
@pytest.mark.parametrize("D,H", WIDE, ids=["XS24", "M"])
def test_wide_cuda_train_path_wiring(emulated, one_thread, D, H, case):
    """Each fused layer's training forward and backward CUDA paths at a
    wide backbone's widths (the recipe's dropout), wrappers emulated: the
    forward's outputs within 2 bf16 ulps of the plain training forward's,
    every gradient within kernel_checks.grad_tols of the plain backward's
    on the same saved tensors."""
    from spe_tpu_torch.ops.kernel_checks import (backward_args, bf16_tol,
                                                 flat_grads, grad_tols,
                                                 max_err, plain_train,
                                                 train_cases)

    name, mod, args, cot = train_cases(B=1, N=40, t=5, Q=6, device="cpu",
                                       D=D, H=H)[case]
    plain_fwd, plain_bwd = plain_train(name, mod)
    with torch.no_grad():
        got = mod._train_cuda(*args)
        want = plain_fwd(*args)
        for g, w in zip(got, want):
            assert max_err(g, w) <= bf16_tol(w, ulps=2), name
        saved = backward_args(args, got[1:], cot)
        grads = flat_grads(name, mod._backward_cuda(*saved))
        ref = flat_grads(name, plain_bwd(*saved))
    tols = grad_tols(ref)
    for k, w in ref.items():
        assert max_err(grads[k], w) <= tols[k], (name, k)
