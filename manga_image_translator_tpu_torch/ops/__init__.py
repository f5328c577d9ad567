from .crf import crf_refine, crf_refine_batch
from .image import (
    gamma_correct,
    letterbox,
    normalize_imagenet,
    pad_to_multiple,
    pick_canonical_size,
    resize_area,
    resize_bilinear,
    rgb_to_gray,
    to_unit,
)
from .morphology import (
    box_blur,
    close_,
    dilate,
    ellipse_kernel,
    erode,
    gaussian_blur,
    open_,
)
from .tiling import (TilePlan, extract_squares, needs_tiling, plan_tiles,
                     stitch_maps)
from .warp import homography_from_quad, warp_perspective, warp_quads_batch
