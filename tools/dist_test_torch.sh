#!/usr/bin/env bash
# Data-parallel evaluation of the PyTorch port: each of GPUS processes
# scores its share of the images (multi_gpu_test); the counterpart of
# tools/dist_test.sh.
# Usage: PORT=29500 bash tools/dist_test_torch.sh CONFIG CHECKPOINT GPUS \
#        --eval mIoU [extra args]
CONFIG=$1
CHECKPOINT=$2
GPUS=$3
shift 3
torchrun --nnodes "${NNODES:-1}" --node_rank "${NODE_RANK:-0}" \
  --master_addr "${MASTER_ADDR:-127.0.0.1}" --master_port "${PORT:-29500}" \
  --nproc_per_node "$GPUS" \
  "$(dirname "$0")/test_torch.py" "$CONFIG" "$CHECKPOINT" \
  --launcher pytorch "$@"
