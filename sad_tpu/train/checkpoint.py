"""Checkpoint save/load + converter for reference-format pickle weights.

Native format: a pickled dict
  {'params': <nested numpy pytree>, 'velocity': <pytree|None>,
   'iter': int, 'cfg_yaml': str}
replacing the reference's flat {'blobs': {unscoped_name: ndarray}, 'cfg': yaml}
(lib/utils/net.py:149-182). AUTO_RESUME scans for model_iter{N}.pkl /
model_final.pkl exactly like train_net.py:208-233.

The converter maps the reference's Caffe2 blob naming (conv1_w,
res2_0_branch2a_w, fpn_inner_res5_2_sum_w, retnet_cls_pred_fpn3_w, ...) to the
sad_tpu param tree and back — module names were chosen to mirror blob
names so this is a pure rename + OIHW->HWIO transpose. This is what unlocks
mAP-parity testing against released reference weights (SURVEY.md §7 step 2).
"""

from __future__ import annotations

import os
import pickle
import re
from typing import Any, Dict, Optional, Tuple

import jax
import numpy as np


# --------------------------------------------------------------------------- #
# Native checkpoints
# --------------------------------------------------------------------------- #


def _to_numpy(tree: Any) -> Any:
    return jax.tree_util.tree_map(lambda x: np.asarray(x), tree)


def save_checkpoint(
    path: str,
    params: Any,
    velocity: Any = None,
    iteration: int = 0,
    cfg_yaml: str = "",
) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {
        "params": _to_numpy(params),
        "velocity": _to_numpy(velocity) if velocity is not None else None,
        "iter": int(iteration),
        "cfg_yaml": cfg_yaml,
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)  # atomic — a crash never leaves a torn checkpoint


def load_checkpoint(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return pickle.load(f)


def find_latest_checkpoint(output_dir: str) -> Tuple[Optional[str], int]:
    """AUTO_RESUME scan (ref: train_net.py:208-233): model_final.pkl wins,
    else the highest model_iter{N}.pkl. Returns (path|None, start_iter)."""
    final = os.path.join(output_dir, "model_final.pkl")
    if os.path.exists(final):
        return final, -1
    best, best_iter = None, -1
    if os.path.isdir(output_dir):
        for fn in os.listdir(output_dir):
            m = re.match(r"model_iter(\d+)\.pkl$", fn)
            if m and int(m.group(1)) > best_iter:
                best_iter = int(m.group(1))
                best = os.path.join(output_dir, fn)
    return best, (best_iter + 1 if best else 0)


# --------------------------------------------------------------------------- #
# Reference-format conversion
# --------------------------------------------------------------------------- #


def _iter_param_paths(tree: Any, prefix=()):  # yields (path_tuple, leaf)
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _iter_param_paths(v, prefix + (k,))
    else:
        yield prefix, tree


def _caffe2_name(path: Tuple[str, ...]) -> Optional[str]:
    """Param path -> Caffe2 blob name. Returns None if unknown."""
    *mods, leaf = path
    module = mods[-1] if mods else ""
    if module.endswith("_bn"):
        if leaf in ("s", "b"):
            return f"{module}_{leaf}"
        return None
    if leaf == "kernel":
        return f"{module}_w"
    if leaf == "bias":
        return f"{module}_b"
    return None


# Modules implemented as ConvTranspose: Caffe2 stores deconv filters IOHW and
# computes the conv-adjoint (kernel effectively flipped vs. models.nn's
# ConvTranspose correlation, verified numerically vs torch), so conversion is
# transpose(2,3,0,1) + spatial flip in BOTH directions.
# Ref: conv_transpose_op_impl.h:40-48 (filter dim0 == input channels),
# mask_rcnn_heads.py conv5_mask, keypoint_rcnn_heads.py:52-84.
_DECONV_MODULES = {"conv5_mask", "kps_score_lowres", "kps_score", "kps_deconv"}


def fc_flatten_resolutions(cfg) -> Dict[str, int]:
    """Spatial resolution of the RoI feature entering each flattening FC.

    The reference flattens NCHW RoI features (CHW row order,
    fast_rcnn_heads.py add_roi_2mlp_head; mask_rcnn_heads.py USE_FC_OUTPUT);
    our heads flatten NHWC, so the first FC's input rows must be permuted for
    real-weight parity. Maps module name -> square spatial resolution.
    """
    return {
        "fc6": cfg.FAST_RCNN.ROI_XFORM_RESOLUTION,
        "mask_fcn_logits": cfg.MRCNN.ROI_XFORM_RESOLUTION,
    }


def _fc_perm_to_flax(res: int, c: int) -> np.ndarray:
    """Row permutation taking CHW-flattened FC input rows to HWC order."""
    return np.arange(c * res * res).reshape(c, res, res).transpose(1, 2, 0).ravel()


def _fc_perm_to_ref(res: int, c: int) -> np.ndarray:
    """Row permutation taking HWC-flattened FC input rows to CHW order."""
    return np.arange(res * res * c).reshape(res, res, c).transpose(2, 0, 1).ravel()


def _kernel_to_ref(arr: np.ndarray, module: str, fc_resolutions) -> np.ndarray:
    if arr.ndim == 4:
        if module in _DECONV_MODULES:
            return arr[::-1, ::-1].transpose(2, 3, 0, 1)  # HWIO -> IOHW + flip
        return arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if arr.ndim == 2:  # Dense: (in, out) -> (out, in)
        res = (fc_resolutions or {}).get(module)
        if res and arr.shape[0] % (res * res) == 0 and arr.shape[0] > res * res:
            arr = arr[_fc_perm_to_ref(res, arr.shape[0] // (res * res))]
        return arr.T
    return arr


def _kernel_to_flax(arr: np.ndarray, module: str, fc_resolutions) -> np.ndarray:
    if arr.ndim == 4:
        if module in _DECONV_MODULES:
            return arr.transpose(2, 3, 0, 1)[::-1, ::-1]  # IOHW -> HWIO + flip
        return arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    if arr.ndim == 2:
        arr = arr.T  # (out, in) -> (in, out)
        res = (fc_resolutions or {}).get(module)
        if res and arr.shape[0] % (res * res) == 0 and arr.shape[0] > res * res:
            arr = arr[_fc_perm_to_flax(res, arr.shape[0] // (res * res))]
        return arr
    return arr


def flax_to_reference_blobs(
    params: Any, fc_resolutions: Optional[Dict[str, int]] = None
) -> Dict[str, np.ndarray]:
    """Export a sad_tpu param tree to reference blob naming/layout (conv
    HWIO->OIHW, deconv HWIO->IOHW+flip, Dense (in,out)->(out,in) with
    HWC->CHW input-row reorder for flattening FCs per fc_resolutions)."""
    blobs: Dict[str, np.ndarray] = {}
    for path, leaf in _iter_param_paths(params):
        name = _caffe2_name(path)
        if name is None:
            raise ValueError(f"Cannot map param path {path} to a blob name")
        arr = np.asarray(leaf)
        if path[-1] == "kernel":
            module = path[-2] if len(path) > 1 else ""
            arr = _kernel_to_ref(arr, module, fc_resolutions)
        blobs[name] = arr
    return blobs


def reference_blobs_to_flax(
    blobs: Dict[str, np.ndarray],
    params_template: Any,
    strict: bool = False,
    fc_resolutions: Optional[Dict[str, int]] = None,
) -> Tuple[Any, list, list]:
    """Fill a param-tree template from reference blobs.

    Shape-mismatched or missing blobs are skipped with the template value
    retained (matching net.py:108-122's skip-on-mismatch behavior).
    Pass fc_resolutions (see fc_flatten_resolutions) so flattening-FC kernels
    get their input rows permuted from the reference's CHW order to HWC.
    Returns (params, loaded_names, skipped_names).
    """
    loaded, skipped = [], []

    def fill(tree, prefix=()):
        if isinstance(tree, dict):
            return {k: fill(v, prefix + (k,)) for k, v in tree.items()}
        name = _caffe2_name(prefix)
        if name is None or name not in blobs:
            skipped.append("/".join(prefix))
            if strict:
                raise KeyError(f"Missing blob for param {'/'.join(prefix)}")
            return tree
        arr = np.asarray(blobs[name], dtype=np.float32)
        if prefix[-1] == "kernel":
            module = prefix[-2] if len(prefix) > 1 else ""
            arr = _kernel_to_flax(arr, module, fc_resolutions)
        if arr.shape != tuple(tree.shape):
            skipped.append("/".join(prefix) + f" (shape {arr.shape} != {tree.shape})")
            if strict:
                raise ValueError(skipped[-1])
            return tree
        loaded.append(name)
        return arr

    return fill(params_template), loaded, skipped


def convert_reference_pickle(
    pkl_path: str,
    params_template: Any,
    strict: bool = False,
    fc_resolutions: Optional[Dict[str, int]] = None,
) -> Tuple[Any, list, list]:
    """Load a reference checkpoint pickle ({'blobs': {...}} or a flat dict of
    blobs, py2 or py3 pickled) into a sad_tpu param tree."""
    with open(pkl_path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    blobs = data.get("blobs", data) if isinstance(data, dict) else data
    return reference_blobs_to_flax(
        blobs, params_template, strict=strict, fc_resolutions=fc_resolutions
    )


def load_reference_weights(
    pkl_path: str,
    params_template: Any,
    fc_resolutions: Optional[Dict[str, int]] = None,
) -> Any:
    params, loaded, skipped = convert_reference_pickle(
        pkl_path, params_template, fc_resolutions=fc_resolutions
    )
    return params
