#!/bin/bash
# Batch-benchmark multiple checkpoints on the same test dir with the port,
# appending to one results CSV (a copy of scripts/test_models.sh). Edit
# MODELS to taste; DEVICE=cpu runs the plain path.
set -u
ROOT=$(git rev-parse --show-toplevel)
RESULTS_PATH="./results.csv"
TEST_DIR="${1:-/data/mvs-test-sessions}"
DEVICE="${DEVICE:-cuda:0}"

cd "$ROOT"

# "model_dir:ckpt_step" entries
MODELS=(
  "/models/baseline:100000"
  "/models/grad_loss:140000"
)

for entry in "${MODELS[@]}"; do
  model_dir="${entry%%:*}"
  step="${entry##*:}"
  python -m mvsnet_tpu_torch.test --input_dir="$TEST_DIR" --results_path="$RESULTS_PATH" \
    --model_dir "$model_dir" --ckpt_step "$step" --device "$DEVICE"
done
