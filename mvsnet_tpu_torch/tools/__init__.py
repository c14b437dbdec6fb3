"""The port's data tools (copies of the repository's `tools/` that use
the port's own IO and codecs): `python -m mvsnet_tpu_torch.tools.<name>`.
They run on the host and take no device, except `hp_search`, whose
training runs take `--device`."""
