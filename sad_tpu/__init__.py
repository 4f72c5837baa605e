"""sad_tpu — Semi-supervised Adaptive Distillation framework in JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of
Tangshitao/Semi-supervised-Adaptive-Distillation (Detectron/Caffe2 fork):
RetinaNet detection, teacher->student adaptive distillation (arXiv:1901.00366),
and the semi-supervised pseudo-label loop — designed for an accelerator
(sharding over a device mesh, static shapes) rather than as a port.

Layer map (vs. the reference's L0-L6, see SURVEY.md):
  sad_tpu.config    — immutable dataclass config system (ref: lib/core/config.py)
  sad_tpu.data      — COCO-JSON datasets, anchors, minibatch, host loader
                      (ref: lib/datasets/, lib/roi_data/)
  sad_tpu.models    — ResNet/ResNeXt-FPN + RetinaNet heads (models/nn.py layer)
                      (ref: lib/modeling/)
  sad_tpu.ops       — loss/box ops incl. the adaptive distillation loss
                      (ref: caffe2/modules/detectron/*.cu)
  sad_tpu.parallel  — mesh / sharding utilities (ref: muji, NCCL/Gloo ops)
  sad_tpu.train     — optimizer, LR policy, train loop, checkpointing
                      (ref: lib/modeling/optimizer.py, tools/train_net.py)
  sad_tpu.eval      — inference engine, box decode + NMS, COCO evaluation
                      (ref: lib/core/test*.py, lib/datasets/json_dataset_evaluator.py)
  sad_tpu.utils     — stats, timers, logging (ref: lib/utils/)
  sad_tpu.native    — C++ host kernels (bbox overlaps / NMS), replacing the
                      reference's Cython extensions (ref: lib/utils/cython_*.pyx)
"""

__version__ = "0.1.0"
