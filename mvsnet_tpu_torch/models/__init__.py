"""The MVSNet 3D-CNN and R-MVSNet ConvGRU graphs and their modules."""

from mvsnet_tpu_torch.models.mvsnet import MVSNet, apply_forward_3dcnn

__all__ = ["MVSNet", "apply_forward_3dcnn"]
