"""The port's orchestration scripts (copies of the repository's
`scripts/`): test-and-fuse over session directories, the 7-Scenes batch
and the optional Sketchfab upload, calling the port's drivers in-process:
`python -m mvsnet_tpu_torch.scripts.<name>`."""
