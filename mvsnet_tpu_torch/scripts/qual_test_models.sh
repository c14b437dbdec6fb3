#!/bin/bash
# Qualitative benchmark with the port: fuse point clouds for visual
# inspection (a copy of scripts/qual_test_models.sh; upload requires
# SKETCHFAB_API_TOKEN and --sketchfab; DEVICE=cpu runs the plain path).
set -u
ROOT=$(git rev-parse --show-toplevel)
TEST_DIR="${1:-/data/mvs-test-sessions}"
MODEL_DIR="${2:-/models/baseline}"
CKPT_STEP="${3:-100000}"
DEVICE="${DEVICE:-cuda:0}"

cd "$ROOT"
python -m mvsnet_tpu_torch.scripts.test_and_fuse --test_folder_root "$TEST_DIR" \
  --model_dir "$MODEL_DIR" --ckpt_step "$CKPT_STEP" --device "$DEVICE" \
  --prob_threshold 0.8 --disp_threshold 0.25 --num_consistent 3
