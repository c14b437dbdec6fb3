"""`python -m mvsnet_tpu_torch`: list the port's entry points."""

COMMANDS = {
    "mvsnet_tpu_torch.train": "train MVSNet / R-MVSNet on session datasets",
    "mvsnet_tpu_torch.test": "benchmark a model against GT depths (results CSV)",
    "mvsnet_tpu_torch.infer": "compute depth + probability maps for sessions",
    "mvsnet_tpu_torch.fusion": "fuse depth maps to a point cloud (on the card, native merge)",
    "mvsnet_tpu_torch.visualize": "view pfm/dmb/npy/png depth maps",
    "mvsnet_tpu_torch.bench": "time the bench points on the card (JSON lines)",
}

if __name__ == "__main__":
    print("mvsnet_tpu_torch: multi-view stereo in PyTorch and CUDA\n")
    for mod, desc in COMMANDS.items():
        print(f"  python -m {mod:<28} {desc}")
    print("\nEntry points run on cuda:0 unless given --device cpu. See README.md.")
