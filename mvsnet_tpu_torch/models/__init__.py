"""The MVSNet 3D-CNN graph and its modules."""

from mvsnet_tpu_torch.models.mvsnet import MVSNet, apply_forward_3dcnn

__all__ = ["MVSNet", "apply_forward_3dcnn"]
