#!/bin/bash
# YFCC in-the-wild evaluation through the PyTorch/CUDA port: the scenes,
# subset sizes, flags and pass-through of scripts/eval3d_yfcc.sh (per
# subset size (nviews, num_consistent) = 5:(5,3) 10:(10,3) 20:(20,3)
# 50:(20,5), --filter with filter_num_views=nviews, COLMAP-fusion
# semantics), driving wildmvs_torch.pipeline.reconstruction. The port runs
# on the card; pass --device cpu among the extra args for the CPU.
set -e
MODEL=${1:?usage: eval3d_yfcc_torch.sh <model_dir> [data_path] [extra args...]}
DATA=${2:-datasets/yfcc_rec}
shift; if [ $# -gt 0 ]; then shift; fi
SCENES="colosseum_exterior grand_place_brussels hagia_sophia_interior \
palace_of_westminster trevi_fountain st_peters_square sacre_coeur taj_mahal \
temple_nara_japan prague_old_town_square pantheon_exterior \
notre_dame_front_facade brandenburg_gate"
for scene in $SCENES; do
  for size in 5 10 20 50; do
    case $size in
      5)  nviews=5;  nc=3 ;;
      10) nviews=10; nc=3 ;;
      20) nviews=20; nc=3 ;;
      50) nviews=20; nc=5 ;;
    esac
    python -m wildmvs_torch.pipeline.reconstruction \
      --dataset yfcc --scene "${scene}_${size}" --model "$MODEL" \
      --data_path "$DATA" --work_dir "$DATA" --nviews $nviews --filter \
      --filter_num_views $nviews --fusion colmap \
      --fusion_num_consistent $nc --compute_metrics "$@"
  done
done
