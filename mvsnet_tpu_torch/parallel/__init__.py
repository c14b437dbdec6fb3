"""Multi-device serving and training over one process per card
(counterpart of mvsnet_tpu/parallel/): the mesh (`mesh.py`), starting ranks
(`launch.py`), the halo convs on depth x space blocks (`halo.py`), sharded
inference (`infer_step.py`) and the sharded train step (`train_step.py`)."""

from mvsnet_tpu_torch.parallel.mesh import AXES, Mesh, factorize_devices, make_mesh

__all__ = ["AXES", "Mesh", "factorize_devices", "make_mesh"]
