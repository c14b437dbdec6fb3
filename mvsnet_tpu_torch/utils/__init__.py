"""Logging and checkpoint-path helpers (copies of mvsnet_tpu/utils/)."""
