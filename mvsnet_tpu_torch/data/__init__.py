"""Data plane: mvs-training session datasets (covisibility clusters), a
copy of mvsnet_tpu/data/ without cv2 (`transforms.scale_image` computes
cv2's resize in numpy), and in-memory synthetic scenes (`synthetic`)."""

from mvsnet_tpu_torch.data.cluster import Cluster  # noqa: F401
from mvsnet_tpu_torch.data.generator import ClusterGenerator  # noqa: F401
from mvsnet_tpu_torch.data.loader import PrefetchingLoader, batch_iterator  # noqa: F401
