"""ctd mask refinement: snap the predicted text mask onto actual text pixels
via per-region Otsu/top-k color thresholding and xor-minimizing CC merging.

Behavioral contract: reference ``detection/ctd_utils/textmask.py`` (+
``imgproc_utils.enlarge_window``). Pure host cv2/numpy by design; a copy
of the JAX package's ``detection/ctd_textmask.py``.
"""
from __future__ import annotations

from typing import List

import cv2
import numpy as np

from ..utils.geometry import Quadrilateral

REFINEMASK_INPAINT = 0
REFINEMASK_ANNOTATION = 1


def enlarge_window(rect, im_w: int, im_h: int, ratio: float = 2.5):
    x1, y1, x2, y2 = rect
    w = x2 - x1
    h = y2 - y1
    if w <= 0 or h <= 0:
        return [0, 0, 0, 0]
    coeff = max((ratio - 1) / 2, 0)
    x1 = max(int(x1 - w * coeff), 0)
    y1 = max(int(y1 - h * coeff), 0)
    x2 = min(int(x2 + w * coeff), im_w)
    y2 = min(int(y2 + h * coeff), im_h)
    return [x1, y1, x2, y2]


def _get_topk_color(color_list, bins, k=3, color_var=10, bin_tol=0.001):
    idx = np.argsort(bins * -1)
    color_list, bins = color_list[idx], bins[idx]
    top_colors = [color_list[0]]
    bin_tol = np.sum(bins) * bin_tol
    if len(color_list) > 1:
        for color, b in zip(color_list[1:], bins[1:]):
            if np.abs(np.array(top_colors) - color).min() > color_var:
                top_colors.append(color)
            if len(top_colors) >= k or b < bin_tol:
                break
    return top_colors


def _minxor_thresh(threshed, mask, dilate=False):
    neg_threshed = 255 - threshed
    if dilate:
        element = cv2.getStructuringElement(cv2.MORPH_RECT, (3, 3), (1, 1))
        neg_threshed = cv2.dilate(neg_threshed, element, iterations=1)
        threshed = cv2.dilate(threshed, element, iterations=1)
    neg_xor_sum = cv2.bitwise_xor(neg_threshed, mask).sum()
    xor_sum = cv2.bitwise_xor(threshed, mask).sum()
    if neg_xor_sum < xor_sum:
        return neg_threshed, neg_xor_sum
    return threshed, xor_sum


def _get_otsuthresh_masklist(img, pred_mask):
    mask_list = []
    for c in range(3):
        _, threshed = cv2.threshold(img[..., c], 1, 255,
                                    cv2.THRESH_OTSU + cv2.THRESH_BINARY)
        threshed, xor_sum = _minxor_thresh(threshed, pred_mask)
        mask_list.append([threshed, xor_sum])
    mask_list.sort(key=lambda x: x[1])
    return [mask_list[0]]


def _get_topk_masklist(im_grey, pred_mask):
    if im_grey.ndim == 3 and im_grey.shape[-1] == 3:
        im_grey = cv2.cvtColor(im_grey, cv2.COLOR_BGR2GRAY)
    msk = np.ascontiguousarray(pred_mask)
    eroded = cv2.erode(msk, np.ones((3, 3), np.uint8), iterations=1)
    candidate = im_grey[np.where(eroded > 127)]
    if candidate.size == 0:
        return []
    bins, hist_edges = np.histogram(candidate, bins=255)
    topk_color = _get_topk_color(hist_edges, bins, color_var=10, k=3)
    color_range = 30
    mask_list = []
    for color in topk_color:
        c_top = min(color + color_range, 255)
        c_bottom = c_top - 2 * color_range
        threshed = cv2.inRange(im_grey, c_bottom, c_top)
        threshed, xor_sum = _minxor_thresh(threshed, msk)
        mask_list.append([threshed, xor_sum])
    return mask_list


def _merge_mask_list(mask_list, pred_mask, pred_thresh=30,
                     refine_mode=REFINEMASK_INPAINT):
    mask_list.sort(key=lambda x: x[1])
    if pred_thresh > 0:
        element = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (3, 3),
                                            (1, 1))
        pred_mask = cv2.erode(pred_mask, element, iterations=1)
        _, pred_mask = cv2.threshold(pred_mask, 60, 255, cv2.THRESH_BINARY)
    mask_merged = np.zeros_like(pred_mask)
    for candidate_mask, _xor in mask_list:
        num_labels, labels, stats, _ = cv2.connectedComponentsWithStats(
            candidate_mask, 8, cv2.CV_16U)
        for label_index in range(1, num_labels):
            x, y, w, h, area = stats[label_index]
            if w * h < 3:
                continue
            x1, y1, x2, y2 = x, y, x + w, y + h
            label_local = labels[y1:y2, x1:x2]
            tmp = np.zeros_like(label_local, np.uint8)
            tmp[label_local == label_index] = 255
            tmp = cv2.bitwise_or(mask_merged[y1:y2, x1:x2], tmp)
            xor_merged = cv2.bitwise_xor(tmp, pred_mask[y1:y2, x1:x2]).sum()
            xor_origin = cv2.bitwise_xor(mask_merged[y1:y2, x1:x2],
                                         pred_mask[y1:y2, x1:x2]).sum()
            if xor_merged < xor_origin:
                mask_merged[y1:y2, x1:x2] = tmp

    if refine_mode == REFINEMASK_INPAINT:
        mask_merged = cv2.dilate(mask_merged, np.ones((5, 5), np.uint8),
                                 iterations=1)
    # fill holes
    num_labels, labels, stats, _ = cv2.connectedComponentsWithStats(
        255 - mask_merged, 8, cv2.CV_16U)
    sorted_area = np.sort(stats[:, -1])
    area_thresh = sorted_area[-2] if len(sorted_area) > 1 else sorted_area[-1]
    for label_index in range(num_labels):
        x, y, w, h, area = stats[label_index]
        if area < area_thresh:
            x1, y1, x2, y2 = x, y, x + w, y + h
            label_local = labels[y1:y2, x1:x2]
            tmp = np.zeros_like(label_local, np.uint8)
            tmp[label_local == label_index] = 255
            tmp = cv2.bitwise_or(mask_merged[y1:y2, x1:x2], tmp)
            xor_merged = cv2.bitwise_xor(tmp, pred_mask[y1:y2, x1:x2]).sum()
            xor_origin = cv2.bitwise_xor(mask_merged[y1:y2, x1:x2],
                                         pred_mask[y1:y2, x1:x2]).sum()
            if xor_merged < xor_origin:
                mask_merged[y1:y2, x1:x2] = tmp
    return mask_merged


def refine_mask(img: np.ndarray, pred_mask: np.ndarray,
                blk_list: List[Quadrilateral],
                refine_mode: int = REFINEMASK_INPAINT) -> np.ndarray:
    mask_refined = np.zeros_like(pred_mask)
    for blk in blk_list:
        bx1, by1, bx2, by2 = enlarge_window(
            [int(v) for v in blk.xyxy], img.shape[1], img.shape[0])
        if bx2 <= bx1 or by2 <= by1:
            continue
        im = np.ascontiguousarray(img[by1:by2, bx1:bx2])
        msk = np.ascontiguousarray(pred_mask[by1:by2, bx1:bx2])
        mask_list = _get_topk_masklist(im, msk)
        mask_list += _get_otsuthresh_masklist(im, msk)
        if not mask_list:
            continue
        mask_merged = _merge_mask_list(mask_list, msk,
                                       refine_mode=refine_mode)
        mask_refined[by1:by2, bx1:bx2] = cv2.bitwise_or(
            mask_refined[by1:by2, bx1:bx2], mask_merged)
    return mask_refined
