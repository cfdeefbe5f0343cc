"""The port's segmentation side against the JAX package on the CPU: the
bilinear resize against jax.image.resize, the segmentation head's three
modules (forward and VJP, f32), the two postprocesses, the mask geometry
and losses, the mask decoders, the coco_panoptic dataset and PQ, the
loader's GT masks, the learned position embedding, and the CAM resize of
cam_pseudo_boxes on a grid larger than cam_cc_size. Weights come from the
JAX modules' init through the port's converter (state_dict_from_jax's
segm_head_state_dict), inputs from numpy with a seed.

Tolerances: the resize 2.4e-7 absolute (the largest difference seen from
jax 0.9.0 is 2.4e-7); the head's outputs and gradients 1e-5 of their
largest magnitude (f32, the frameworks sum in other orders); the losses
1e-6 relative; everything discrete (postprocesses, boxes, decoders, PQ,
loader, learned embedding, CAM boxes) exactly."""

import json
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from spe_tpu.data import coco_panoptic as jpan
from spe_tpu.data import masks as jmasks
from spe_tpu.data import panoptic_eval as jpq
from spe_tpu.data.loader import DataLoader as JLoader
from spe_tpu.data.synthetic import SyntheticDetection as JSynthetic
from spe_tpu.models import segmentation as jseg
from spe_tpu.models.position_encoding import PositionEmbeddingLearned
from spe_tpu.ops import boxes as jboxes
from spe_tpu.ops import losses as jlosses
from spe_tpu.ops.cam_boxes import cam_pseudo_boxes as jax_cam_boxes
from spe_tpu.train.criterion import mask_losses as jax_mask_losses
from spe_tpu_torch.data import coco_panoptic as tpan
from spe_tpu_torch.data import masks as tmasks
from spe_tpu_torch.data import panoptic_eval as tpq
from spe_tpu_torch.data.loader import DataLoader
from spe_tpu_torch.data.synthetic import SyntheticDetection
from spe_tpu_torch.models import position_encoding as tpos
from spe_tpu_torch.models import segmentation as tseg
from spe_tpu_torch.models.convert import segm_head_state_dict
from spe_tpu_torch.ops import boxes as tboxes
from spe_tpu_torch.ops import losses as tlosses
from spe_tpu_torch.ops.cam_boxes import cam_pseudo_boxes
from spe_tpu_torch.ops.resize import resize_bilinear
from spe_tpu_torch.train.criterion import mask_losses

D, NH = 32, 4
# biases whose exact gradient is zero: k_linear's (the softmax over
# positions ignores a per-query constant) and each conv's before a
# GroupNorm (which subtracts the group mean); both frameworks give
# roundoff there, held against the weight's gradient scale
ZERO_GRAD = ("k_linear.bias", "conv_0.bias", "conv_1.bias", "conv_2.bias")


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _close(got, want, rel=1e-5, scale=None):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape
    tol = rel * max(np.abs(want).max() if scale is None else scale, 1e-30)
    assert np.abs(got - want).max() <= tol, (np.abs(got - want).max(), tol)


@pytest.mark.parametrize("src,dst", [((512, 512), (128, 128)),
                                     ((100, 80), (64, 64)),
                                     ((96, 96), (64, 64)),
                                     ((32, 32), (64, 64)),
                                     ((20, 30), (48, 36))])
def test_resize_matches_jax_image_resize(rng, src, dst):
    x = rng.uniform(size=(2, 3) + src).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 3) + dst,
                                       "bilinear"))
    got = resize_bilinear(_t(x), dst).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2.4e-7)


def _head(rng, B=2, Q=5, h=4, w=3):
    hs = rng.normal(size=(B, Q, D)).astype(np.float32)
    feat = rng.normal(size=(B, h, w, D)).astype(np.float32)
    pad = np.zeros((B, h * w), bool)
    pad[1, -w:] = True   # the second image's last row is padding
    m = jseg.SegmentationHead(D, num_heads=NH)
    params = m.init(jax.random.PRNGKey(0), jnp.asarray(hs), jnp.asarray(feat))
    tree = jax.tree_util.tree_map(np.asarray, params["params"])
    # GroupNorm scales and biases off their 1 / 0 init so they show
    for name in ("gn_0", "gn_1", "gn_2"):
        g = tree["mask_head"][name]
        g["scale"] = (1 + 0.1 * rng.normal(size=g["scale"].shape)).astype(
            np.float32)
        g["bias"] = (0.1 * rng.normal(size=g["bias"].shape)).astype(np.float32)
    port = tseg.SegmentationHead(D, num_heads=NH)
    port.load_state_dict(segm_head_state_dict(tree))
    return hs, feat, pad, m, tree, port


def _vjp_check(jfn, tfn, inputs, full, prefix, module, rng):
    """Forward and VJP (inputs and parameters) of a JAX function of
    (params, *inputs) and the port's module on the same cotangent; the
    parameters are the head's tree `full`, or its part `prefix`."""
    tree = full if prefix is None else full[prefix]
    out, vjp = jax.vjp(jfn, tree, *[jnp.asarray(x) for x in inputs])
    cot = rng.normal(size=out.shape).astype(np.float32)
    grads = vjp(jnp.asarray(cot))
    ts = [_t(x).requires_grad_(True) for x in inputs]
    got = tfn(*ts)
    _close(got.detach().numpy(), out)
    got.backward(_t(cot))
    for t, g in zip(ts, grads[1:]):
        _close(t.grad.numpy(), g)
    g = jax.tree_util.tree_map(np.asarray, grads[0])
    if prefix is not None:   # the other part's gradient: zeros
        g = {**jax.tree_util.tree_map(np.zeros_like, full), prefix: g}
    want = segm_head_state_dict(g)
    names = dict(module.named_parameters())
    for name, p in names.items():
        key = name if prefix is None else f"{prefix}.{name}"
        # exactly zero gradients are held against their weight's scale
        ref = key.replace(".bias", ".weight") if key.endswith(
            ZERO_GRAD) else key
        _close(p.grad.numpy(), want[key].numpy(),
               scale=np.abs(want[ref].numpy()).max())
    assert len(names) == len(want) if prefix is None else len(names) > 1


def test_mh_attention_map_matches_jax(rng):
    hs, feat, pad, m, tree, port = _head(rng)
    sub = jseg.MHAttentionMap(D, NH)

    def jfn(p, q, f):
        return sub.apply({"params": p}, q, f,
                         pad_mask=jnp.asarray(pad))

    _vjp_check(jfn, lambda q, f: port.bbox_attention(q, f, torch.from_numpy(
        pad)), (hs, feat), tree, "bbox_attention", port.bbox_attention, rng)


def test_mask_head_matches_jax(rng):
    hs, feat, pad, m, tree, port = _head(rng)
    attn = rng.uniform(size=(2, 5, NH, 4, 3)).astype(np.float32)
    sub = jseg.MaskHead(D, NH)
    _vjp_check(lambda p, f, a: sub.apply({"params": p}, f, a),
               port.mask_head, (feat, attn), tree, "mask_head",
               port.mask_head, rng)


def test_segmentation_head_matches_jax(rng):
    hs, feat, pad, m, tree, port = _head(rng)

    def jfn(p, q, f):
        return m.apply({"params": p}, q, f, pad_mask=jnp.asarray(pad))

    out = jfn(tree, jnp.asarray(hs), jnp.asarray(feat))
    assert out.shape == (2, 5, 16, 12)
    _vjp_check(jfn, lambda q, f: port(q, f, torch.from_numpy(pad)),
               (hs, feat), tree, None, port, rng)


def test_postprocess_segm_matches_jax(rng):
    logits = rng.normal(size=(2, 6, 8, 7)).astype(np.float32)
    keep = np.array([[0, 2, 5], [4, 1, 1]], np.int32)
    for size in ((32, 28), (20, 41), (8, 7)):
        want = np.asarray(jseg.postprocess_segm(
            jnp.asarray(logits), jnp.asarray(keep), size))
        got = tseg.postprocess_segm(_t(logits), torch.from_numpy(
            keep).long(), size).numpy()
        assert got.dtype == bool and want.dtype == bool
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("target_size", [None, (37, 50)])
def test_postprocess_panoptic_matches_jax(rng, target_size):
    """Thing and stuff queries, two of one stuff class (merged), a small
    segment that the area rule drops, no-object and low-score queries."""
    Q, K = 10, 6
    logits = rng.normal(size=(Q, K)).astype(np.float32)
    cls = [1, 2, 3, 3, 4, 1, 5, 2, 0, 4]
    for q, c in enumerate(cls):
        logits[q, c] += 8.0
    logits[8, K - 1] += 20.0     # no-object
    logits[9] = 0.0              # a low score
    masks = rng.normal(size=(Q, 12, 16)).astype(np.float32)
    masks[5] -= 6.0              # nearly nowhere: dropped by min_area
    is_thing = {1: True, 2: True, 3: False, 4: False, 5: True}
    want = jseg.postprocess_panoptic(logits, masks, is_thing, (24, 32),
                                     target_size)
    got = tseg.postprocess_panoptic(logits, masks, is_thing, (24, 32),
                                    target_size)
    np.testing.assert_array_equal(got["id_map"], want["id_map"])
    assert got["segments_info"] == want["segments_info"]
    assert got["png_string"] == want["png_string"]
    assert len(want["segments_info"]) >= 3


def test_postprocess_panoptic_nothing_kept(rng):
    logits = np.zeros((4, 5), np.float32)
    masks = rng.normal(size=(4, 6, 6)).astype(np.float32)
    want = jseg.postprocess_panoptic(logits, masks, {}, (12, 12))
    got = tseg.postprocess_panoptic(logits, masks, {}, (12, 12))
    np.testing.assert_array_equal(got["id_map"], want["id_map"])
    assert got["segments_info"] == want["segments_info"] == []


def test_mask_geometry_and_losses_match_jax(rng):
    masks = (rng.uniform(size=(6, 9, 11)) > 0.8).astype(np.uint8)
    masks[2] = 0                 # empty: zeros
    np.testing.assert_array_equal(
        tboxes.masks_to_boxes(torch.from_numpy(masks)).numpy(),
        np.asarray(jboxes.masks_to_boxes(jnp.asarray(masks))))
    logits = rng.normal(size=(5, 40)).astype(np.float32)
    targets = (rng.uniform(size=(5, 40)) > 0.5).astype(np.float32)
    rm = np.array([1, 1, 0, 1, 0], np.float32)
    for row_mask in (None, rm):
        jr = None if row_mask is None else jnp.asarray(row_mask)
        tr = None if row_mask is None else _t(row_mask)
        for jfn, tfn, kw in (
                (jlosses.dice_loss, tlosses.dice_loss, {}),
                (jlosses.sigmoid_focal_loss_masks,
                 tlosses.sigmoid_focal_loss_masks, {}),
                (jlosses.sigmoid_focal_loss_masks,
                 tlosses.sigmoid_focal_loss_masks,
                 {"alpha": -1.0, "gamma": 0.5})):
            want = float(jfn(jnp.asarray(logits), jnp.asarray(targets), 3.0,
                             row_mask=jr, **kw))
            got = float(tfn(_t(logits), _t(targets), 3.0, row_mask=tr, **kw))
            assert got == pytest.approx(want, rel=1e-6)


def test_mask_losses_match_jax(rng):
    """criterion.mask_losses: the matched queries' masks (one unassigned,
    -1, and padded targets) against GT masks shrunk from 64^2 to 16^2."""
    B, Q, T = 2, 7, 4
    pred = rng.normal(size=(B, Q, 16, 16)).astype(np.float32)
    gt = (rng.uniform(size=(B, T, 64, 64)) > 0.6).astype(np.uint8)
    rows = np.array([[3, 0, 6, -1], [2, 5, 0, 0]], np.int32)
    tmask = np.array([[True, True, True, True], [True, True, False, False]])
    want = jax_mask_losses(jnp.asarray(pred), jnp.asarray(gt),
                           jnp.asarray(rows), jnp.asarray(tmask),
                           jnp.float32(5.0), focal_alpha=0.25,
                           focal_gamma=2.0)
    got = mask_losses(_t(pred), torch.from_numpy(gt), torch.from_numpy(rows),
                      torch.from_numpy(tmask), torch.tensor(5.0))
    for k in ("loss_mask", "loss_dice"):
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-6), k


def _encode_rle(counts):
    """pycocotools' ascii packing of RLE counts (the inverse of the
    decoders' _decode_compressed_counts)."""
    s = bytearray()
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not (x == 0 and not (c & 0x10)) and \
                not (x == -1 and (c & 0x10))
            if more:
                c |= 0x20
            s.append(c + 48)
    return s.decode()


def _rle_counts(m):
    flat = m.T.ravel()
    counts, run, val = [], 0, 0
    for px in flat:
        if px == val:
            run += 1
        else:
            counts.append(run)
            run, val = 1, px
    counts.append(run)
    return counts


def test_mask_decoders_match_jax(rng):
    for _ in range(6):
        n = int(rng.integers(3, 9))
        ang = np.sort(rng.uniform(0, 2 * np.pi, n))
        r = rng.uniform(3, 14, n)
        cx, cy = rng.uniform(12, 28, 2)
        poly = np.stack([cx + r * np.cos(ang), cy + r * np.sin(ang)],
                        1).ravel().tolist()
        np.testing.assert_array_equal(tmasks.rasterize_polygon(poly, 40, 36),
                                      jmasks.rasterize_polygon(poly, 40, 36))
        polys = [poly, [1, 1, 9, 1, 9, 7, 1, 7]]
        np.testing.assert_array_equal(tmasks.ann_to_mask(polys, 40, 36),
                                      jmasks.ann_to_mask(polys, 40, 36))
        m = (rng.uniform(size=(17, 13)) > 0.5).astype(np.uint8)
        counts = _rle_counts(m)
        for rle in ({"counts": counts, "size": [17, 13]},
                    {"counts": _encode_rle(counts), "size": [17, 13]}):
            got = tmasks.decode_rle(rle)
            np.testing.assert_array_equal(got, m)
            np.testing.assert_array_equal(got, jmasks.decode_rle(rle))
            np.testing.assert_array_equal(tmasks.ann_to_mask(rle, 17, 13),
                                          jmasks.ann_to_mask(rle, 17, 13))


def _panoptic_tree(tmp_path, rng, n=3):
    img_dir, ann_dir = tmp_path / "imgs", tmp_path / "panoptic"
    img_dir.mkdir()
    ann_dir.mkdir()
    images, anns = [], []
    for i in range(n):
        h, w = 20 + i, 30
        Image.fromarray(rng.integers(0, 255, (h, w, 3)).astype(
            np.uint8)).save(img_dir / f"img{i}.jpg")
        ids = np.zeros((h, w), np.int64)
        ids[2:10, 3:12] = 5
        ids[11:18, 4:20] = 300 + i        # G channel in use
        ids[0:6, 20:29] = 70000           # B channel in use
        rgb = np.stack([ids % 256, ids // 256 % 256, ids // 65536],
                       -1).astype(np.uint8)
        Image.fromarray(rgb).save(ann_dir / f"img{i}.png")
        images.append({"id": i, "file_name": f"img{i}.jpg", "width": w,
                       "height": h})
        anns.append({"image_id": i, "file_name": f"img{i}.png",
                     "segments_info": [
                         {"id": 5, "category_id": 2, "bbox": [3, 2, 9, 8],
                          "area": 72, "iscrowd": 0},
                         {"id": 300 + i, "category_id": 4,
                          "bbox": [4, 11, 16, 7], "area": 112,
                          "iscrowd": int(i == 1)},
                         {"id": 70000, "category_id": 7,
                          "bbox": [20, 0, 9, 6], "area": 54, "iscrowd": 0}]})
    ann = {"images": images, "annotations": anns[::-1],
           "categories": [{"id": c, "name": f"c{c}", "isthing": int(c < 5)}
                          for c in (2, 4, 7)]}
    p = tmp_path / "panoptic.json"
    p.write_text(json.dumps(ann))
    return img_dir, ann_dir, p


def test_coco_panoptic_and_pq_match_jax(tmp_path, rng):
    img_dir, ann_dir, p = _panoptic_tree(tmp_path, rng)
    png = rng.integers(0, 255, (5, 7, 3)).astype(np.uint8)
    np.testing.assert_array_equal(tpan.decode_segment_map(png),
                                  jpan.decode_segment_map(png))
    got_ds = tpan.CocoPanopticDataset(img_dir, ann_dir, p)
    want_ds = jpan.CocoPanopticDataset(img_dir, ann_dir, p)
    assert len(got_ds) == len(want_ds) == 3
    tev, jev = tpq.PanopticEvaluator(), jpq.PanopticEvaluator()
    for i in range(3):
        (gi, gt), (wi, wt) = got_ds[i], want_ds[i]
        np.testing.assert_array_equal(gi, wi)
        assert gt.keys() == wt.keys()
        for k in wt:
            np.testing.assert_array_equal(gt[k], wt[k], err_msg=k)
        assert gt["masks"].shape[0] == 3 and gt["masks"].any((1, 2)).all()
        seg_map, segs = got_ds.load_segments(i)
        # a prediction: the GT map with one segment moved and one cut
        pred = seg_map.copy()
        pred[pred == 5] = 0
        pred[2:8, 3:12] = 9
        pred[0:3, 20:29] = 0
        psegs = [{"id": 9, "category_id": 2},
                 {"id": 300 + i, "category_id": 4},
                 {"id": 70000, "category_id": 7}]
        want = jpq.pq_compute_single(seg_map, segs, pred, psegs)
        assert tpq.pq_compute_single(seg_map, segs, pred, psegs) == want
        tev.update(seg_map, segs, pred, psegs)
        jev.update(seg_map, segs, pred, psegs)
    assert tev.summarize() == jev.summarize()
    assert 0 < tev.summarize()["PQ"] < 1


def test_loader_gt_masks_match_jax():
    """The loader's GT masks padded into the canvas, under the train
    transform (flip) and the multi-scale one's resize."""
    from spe_tpu.data.transforms import MultiScaleTransform as JMS
    from spe_tpu_torch.data.transforms import MultiScaleTransform

    for tf_j, tf_t, fixed in ((None, None, 64),
                              (JMS(max_size=96, train=True),
                               MultiScaleTransform(max_size=96, train=True),
                               None)):
        jds = JSynthetic(num_images=6, num_classes=4, img_size=64, seed=0,
                         return_masks=True, transform=tf_j)
        tds = SyntheticDetection(num_images=6, num_classes=4, img_size=64,
                                 seed=0, return_masks=True, transform=tf_t)
        random.seed(0)
        want = list(JLoader(jds, 3, 4, fixed_size=fixed, seed=0, max_gt=5,
                            num_threads=1).epoch(0))
        random.seed(0)
        got = list(DataLoader(tds, 3, 4, fixed_size=fixed, seed=0, max_gt=5,
                              num_threads=1).epoch(0))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert g["gt_masks"].shape == w["gt_masks"].shape
            assert g["gt_masks"].any()
            for k in ("gt_masks", "gt_mask", "gt_boxes", "gt_labels"):
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_position_embedding_learned_matches_jax(rng):
    m = PositionEmbeddingLearned(num_pos_feats=6)
    params = m.init(jax.random.PRNGKey(0), (2, 3, 4))
    port = tpos.PositionEmbeddingLearned(6)
    with torch.no_grad():
        for n in ("col_embed", "row_embed"):
            getattr(port, n).weight.copy_(_t(params["params"][n]))
    for shape in ((2, 3, 4), (1, 50, 7), (3, 5, 50)):
        np.testing.assert_array_equal(port(*shape).detach().numpy(),
                                      np.asarray(m.apply(params, shape)))
    with pytest.raises(ValueError, match="larger than"):
        port(1, 51, 4)
    assert tpos.build_position_encoding(12, "sine") is None
    assert tpos.build_position_encoding(12, "v3").num_pos_feats == 6
    with pytest.raises(ValueError, match="not supported"):
        tpos.build_position_encoding(12, "cosine")


@pytest.mark.parametrize("grid,size", [(24, 16), (40, 32), (20, 16),
                                       (96, 64)])
def test_cam_boxes_shrink_matches_jax(rng, grid, size):
    """A CAM grid larger than cam_cc_size: shrunk (antialiased) as
    spe_tpu/ops/cam_boxes.py:229 does, no longer refused; boxes, labels
    and masks exactly the JAX function's. (cam_cc_size a power of two, as
    the presets set it: XLA turns the boxes' division by it into a product
    by its reciprocal, one ulp away from the quotient for other sizes.)"""
    B, C = 2, 5
    cams = rng.normal(size=(B, C, grid, grid)).astype(np.float32)
    yy, xx = np.mgrid[:grid, :grid]
    for b in range(B):
        for c in range(C):   # a blob or two a map, so components differ
            for _ in range(int(rng.integers(1, 3))):
                cy, cx = rng.uniform(0, grid, 2)
                cams[b, c] += 4 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                                         / (2 * (grid / 8) ** 2))
    label = np.zeros((B, C), np.float32)
    label[0, [1, 3]] = 1
    label[1, [0, 2, 4]] = 1
    kw = dict(area_ratio=0.1, size=size, k=2, max_boxes=8, max_pos=3)
    want = jax.block_until_ready(jax.jit(
        lambda c, l: jax_cam_boxes(c, l, 0.2, **kw))(jnp.asarray(cams),
                                                     jnp.asarray(label)))
    got = cam_pseudo_boxes(_t(cams), _t(label), 0.2, **kw)
    assert int(np.asarray(want["mask"]).sum()) >= 5
    for k in ("boxes", "labels", "mask"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
