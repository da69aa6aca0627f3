#!/usr/bin/env bash
# Data-parallel training of the PyTorch port: one process a GPU under
# torchrun (the counterpart of tools/dist_train.sh, rsiseg's
# dist_train.sh).
# Usage: [NNODES=2 NODE_RANK=0 MASTER_ADDR=host] PORT=29500 \
#        bash tools/dist_train_torch.sh CONFIG GPUS [extra args]
CONFIG=$1
GPUS=$2
shift 2
torchrun --nnodes "${NNODES:-1}" --node_rank "${NODE_RANK:-0}" \
  --master_addr "${MASTER_ADDR:-127.0.0.1}" --master_port "${PORT:-29500}" \
  --nproc_per_node "$GPUS" \
  "$(dirname "$0")/train_torch.py" "$CONFIG" --launcher pytorch "$@"
