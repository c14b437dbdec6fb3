"""The MVSNet 3D-CNN and R-MVSNet ConvGRU graphs, CasMVSNet's cascade, and
their modules."""

from mvsnet_tpu_torch.config import ModelConfig
from mvsnet_tpu_torch.models.casmvsnet import CasMVSNet
from mvsnet_tpu_torch.models.mvsnet import MVSNet, apply_forward_3dcnn

__all__ = ["CasMVSNet", "MVSNet", "apply_forward_3dcnn", "build_model"]


def build_model(cfg: ModelConfig, seed: int = 0):
    """The model that `cfg` describes, seeded with `seed`: CasMVSNet's
    cascade with `cfg.cascade`, else MVSNet's 3D-CNN or GRU graph. Each
    serves through `serve(images, cams, depth_start, depth_interval,
    depth_end) -> (depth, prob, residual)` and says whether those maps are
    at the images' resolution (`maps_at_image_resolution`)."""
    return (CasMVSNet if cfg.cascade else MVSNet)(cfg, seed=seed)
