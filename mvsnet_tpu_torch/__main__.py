"""`python -m mvsnet_tpu_torch`: list the port's entry points."""

COMMANDS = {
    "mvsnet_tpu_torch.train": "train MVSNet / R-MVSNet on session datasets",
    "mvsnet_tpu_torch.test": "benchmark a model against GT depths (results CSV)",
    "mvsnet_tpu_torch.infer": "compute depth + probability maps for sessions",
    "mvsnet_tpu_torch.fusion": "fuse depth maps to a point cloud (on the card, native merge)",
    "mvsnet_tpu_torch.visualize": "view pfm/dmb/npy/png depth maps",
    "mvsnet_tpu_torch.bench": "time the bench points on the card (JSON lines)",
    "mvsnet_tpu_torch.scripts.test_and_fuse": "inference, fusion and PLY collection over sessions",
    "mvsnet_tpu_torch.scripts.seven_scenes_test": "test-and-fuse over the 7-Scenes test sessions",
    "mvsnet_tpu_torch.tools.convert_dtu": "DTU scans (Cameras/Rectified/Depths) -> sessions",
    "mvsnet_tpu_torch.tools.dtu_fixer": "converted DTU sessions: depths to 640x512, focal fix",
    "mvsnet_tpu_torch.tools.convert_demon": "DeMoN scenes -> sessions (--fix cleans them)",
    "mvsnet_tpu_torch.tools.split_data": "split a directory of sessions into train/val/test",
    "mvsnet_tpu_torch.tools.eval_pointcloud": "score a fused PLY against a ground-truth cloud",
    "mvsnet_tpu_torch.tools.hp_search": "Bayesian hyperparameter search over training runs",
}

if __name__ == "__main__":
    print("mvsnet_tpu_torch: multi-view stereo in PyTorch and CUDA\n")
    for mod, desc in COMMANDS.items():
        print(f"  python -m {mod:<43} {desc}")
    print("\nEntry points run on cuda:0 unless given --device cpu; the data tools run on "
          "the host. See README.md.")
