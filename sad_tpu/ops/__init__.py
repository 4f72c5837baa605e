from .losses import (
    sigmoid_focal_loss,
    sigmoid_adaptive_distill_loss,
    select_smooth_l1_loss,
    smooth_l1_loss,
    pow_sum,
)
from .box_transforms import (
    bbox_transform,
    bbox_transform_inv,
    clip_boxes,
    bbox_overlaps,
)
from .nms import batched_nms, nms_fixed, soft_nms
from .detectron_ops import (
    roi_align,
    roi_pool,
    ps_roi_pool,
    group_spatial_softmax,
    softmax_focal_loss,
    sigmoid_cross_entropy_loss,
    batch_permutation,
    sample_as,
    spatial_narrow_as,
    spatial_l2_loss,
    spatial_sigmoid,
    affine_channel,
    upsample_nearest,
    zero_even,
    softmax_with_loss_ohem,
    smooth_l1_loss_per_roi,
    box_annotator_ohem,
)
from .proposals import (
    generate_proposals,
    collect_and_distribute_fpn_proposals,
    map_rois_to_fpn_levels,
    multilevel_roi_align,
    sample_proposal_labels,
)

__all__ = [
    "sigmoid_focal_loss",
    "sigmoid_adaptive_distill_loss",
    "select_smooth_l1_loss",
    "smooth_l1_loss",
    "pow_sum",
    "bbox_transform",
    "bbox_transform_inv",
    "clip_boxes",
    "bbox_overlaps",
    "batched_nms",
    "nms_fixed",
]
