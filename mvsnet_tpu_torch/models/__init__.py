"""The MVSNet 3D-CNN and R-MVSNet ConvGRU graphs, CasMVSNet's cascade, and
their modules."""

from mvsnet_tpu_torch.models.casmvsnet import CasMVSNet
from mvsnet_tpu_torch.models.mvsnet import MVSNet, apply_forward_3dcnn

__all__ = ["CasMVSNet", "MVSNet", "apply_forward_3dcnn"]
