#!/bin/bash
# DTU 3D evaluation sweep through the PyTorch/CUDA port: the scan list,
# flags and pass-through of scripts/eval3d_dtu.sh (fusion depth threshold
# 0.25, the reference's scan list, extra args pass through), driving
# wildmvs_torch.pipeline.reconstruction (its fusion on the card). The port
# runs on the card; pass --device cpu among the extra args for the CPU.
set -e
MODEL=${1:?usage: eval3d_dtu_torch.sh <model_dir> [data_path] [extra args...]}
DATA=${2:-datasets/dtu_eval}
shift; if [ $# -gt 0 ]; then shift; fi
SCANS="1 4 9 10 11 12 13 15 23 24 29 32 33 34 48 49 62 75 77 110 114 118"
for s in $SCANS; do
  python -m wildmvs_torch.pipeline.reconstruction \
    --dataset dtu --scene scan$s --model "$MODEL" --data_path "$DATA" \
    --work_dir "$DATA" --fusion fusibile --fusion_depth_threshold 0.25 \
    --fusion_num_consistent 3 --compute_metrics --override "$@"
done
