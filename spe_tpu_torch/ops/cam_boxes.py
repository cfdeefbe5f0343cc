"""CAM -> pseudo ground-truth boxes (port of spe_tpu/ops/cam_boxes.py
:116-270; reference engine.py:356-398 `get_pseudo_label_multi_boxes`,
cams_deit.py:9-96).

Per image, for the `max_pos` positive classes with the strongest CAM
evidence:
  1. bilinear resize of the CAM to a `size x size` grid (ops/resize.py,
     as jax.image.resize: half-pixel centres, antialiased when it shrinks;
     it enlarges on the recipe, 32 -> 64),
  2. min-max normalise and threshold at `cam*255 > floor(cam_thr*255)`,
  3. 8-connected components (kernel 5: ops/connected_components.py, ONE
     launch for all B * max_pos masks of the step on the card),
  4. component areas by sort + run lengths, the k largest kept if at least
     area_ratio x the largest, their bounding boxes,
  5. packed into a fixed budget of `max_boxes` in the reference order
     (class ascending, area descending), labels = class index + 1, boxes
     normalised cxcywh.
Runs under no_grad: the pseudo-boxes are targets, not outputs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from spe_tpu_torch.ops.boxes import box_xyxy_to_cxcywh
from spe_tpu_torch.ops.connected_components import BIG, connected_components
from spe_tpu_torch.ops.resize import resize_bilinear


def _cam_threshold_mask(cam, cam_thr):
    """Min-max normalise each (S, S) map of (..., S, S) and threshold it
    (reference cams_deit.py:40-45, THRESH_TOZERO keeps strictly greater)."""
    cam = torch.nan_to_num(cam.float())
    cam = cam - cam.amin(dim=(-2, -1), keepdim=True)
    cam = cam / cam.amax(dim=(-2, -1), keepdim=True).clamp(min=1e-12)
    thr = torch.as_tensor(cam_thr, dtype=torch.float32, device=cam.device)
    return cam * 255.0 > torch.floor(thr * 255.0)


def _labels_to_class_boxes(labels, area_ratio: float, k: int):
    """(M, S, S) label grids -> boxes (M, k, 4) xyxy in [0, 1] and valid
    (M, k): the k largest components with area >= area_ratio x the largest;
    [0, 0, 1/S, 1/S] when none (only an all-non-finite CAM)."""
    M, S, _ = labels.shape
    n = S * S
    flat = labels.reshape(M, n)
    sl, _ = torch.sort(flat, dim=1)
    pos = torch.arange(n, device=labels.device)
    start = torch.ones_like(sl, dtype=torch.bool)
    start[:, 1:] = sl[:, 1:] != sl[:, :-1]
    # next run start after each position: reverse cummin of start positions
    nxt = torch.where(start, pos, n).flip(1).cummin(1).values.flip(1)
    nxt = torch.cat([nxt[:, 1:], torch.full((M, 1), n, device=labels.device,
                                             dtype=nxt.dtype)], 1)
    runlen = torch.where(start & (sl < BIG), nxt - pos, 0)
    # top-k with the lower index first on ties, as jax.lax.top_k
    order = torch.sort(runlen, dim=1, descending=True, stable=True).indices
    idx_k = order[:, :k]
    area_k = runlen.gather(1, idx_k)
    roots = sl.gather(1, idx_k)
    max_area = area_k[:, :1]
    valid = (area_k > 0) & (area_k.float() >= area_ratio * max_area.float())

    ys = (pos // S)[None, None, :]
    xs = (pos % S)[None, None, :]
    eq = (flat[:, None, :] == roots[:, :, None]) & (flat[:, None, :] < BIG)
    x0 = torch.where(eq, xs, S).amin(-1).float() / S
    y0 = torch.where(eq, ys, S).amin(-1).float() / S
    x1 = (torch.where(eq, xs, -1).amax(-1) + 1).float() / S
    y1 = (torch.where(eq, ys, -1).amax(-1) + 1).float() / S
    boxes = torch.stack([x0, y0, x1, y1], -1)

    none_valid = ~valid.any(1)
    fallback = torch.tensor([0.0, 0.0, 1.0 / S, 1.0 / S],
                            device=labels.device)
    boxes = torch.where(none_valid[:, None, None], fallback, boxes)
    valid = valid.clone()
    valid[:, 0] |= none_valid
    return boxes, valid


@torch.no_grad()
def cam_pseudo_boxes(cams, img_label, cam_thr, area_ratio: float = 0.5,
                     size: int = 64, k: int = 4, max_boxes: int = 24,
                     max_pos=None):
    """Pseudo GT boxes from class-attention maps for a batch.

    cams (B, C, h, w) raw CAMs; img_label (B, C) multi-hot; cam_thr a float.
    max_pos: the budget of positive classes per image; images with more
    keep those with the largest CAM range (ties to the lower class), then
    in ascending class order.
    -> {boxes (B, max_boxes, 4) cxcywh, labels (B, max_boxes) int64 class
        index + 1 (0 where invalid), mask (B, max_boxes) bool}."""
    B, C = cams.shape[:2]
    dev = cams.device
    if max_pos is not None and max_pos < C:
        P = max_pos
        rng_ev = (cams.amax(dim=(2, 3)) - cams.amin(dim=(2, 3))).float()
        score = torch.where(img_label > 0, torch.nan_to_num(rng_ev), -1.0)
        pos_idx = torch.sort(score, dim=1, descending=True,
                             stable=True).indices[:, :P]
        pos_idx = torch.sort(pos_idx, dim=1).values
        sel_cams = cams.gather(1, pos_idx[:, :, None, None].expand(
            -1, -1, *cams.shape[2:]))
        sel_label = img_label.gather(1, pos_idx)
    else:
        P = C
        pos_idx = torch.arange(C, device=dev)[None].expand(B, C)
        sel_cams, sel_label = cams, img_label

    masks = _cam_threshold_mask(
        resize_bilinear(sel_cams.float(), (size, size)), cam_thr)
    labels = connected_components(masks.reshape(B * P, size, size))
    boxes, valid = _labels_to_class_boxes(labels, area_ratio, k)
    boxes = boxes.reshape(B, P, k, 4)
    valid = valid.reshape(B, P, k) & (sel_label > 0)[:, :, None]

    cls_ids = pos_idx[:, :, None].expand(B, P, k)
    rank = torch.arange(k, device=dev)[None, None].expand(B, P, k)
    key = torch.where(valid, cls_ids * k + rank, C * k + 1).reshape(B, P * k)
    n_keep = min(max_boxes, P * k)
    order = torch.sort(key, dim=1, stable=True).indices[:, :n_keep]
    out_boxes = boxes.reshape(B, P * k, 4).gather(
        1, order[..., None].expand(-1, -1, 4))
    out_valid = valid.reshape(B, P * k).gather(1, order)
    out_labels = (cls_ids + 1).reshape(B, P * k).gather(1, order)
    if n_keep < max_boxes:
        pad = max_boxes - n_keep
        out_boxes = F.pad(out_boxes, (0, 0, 0, pad))
        out_valid = torch.cat([out_valid, out_valid.new_zeros(B, pad)], 1)
        out_labels = F.pad(out_labels, (0, pad))
    return {"boxes": box_xyxy_to_cxcywh(out_boxes),
            "labels": torch.where(out_valid, out_labels, 0),
            "mask": out_valid}
