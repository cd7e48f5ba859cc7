#!/usr/bin/env bash
# The TODA two-stage recipe through the PyTorch port's CLIs: stage-1 mix
# training, pseudo labels with the input perturbation, stage-2 MixUp with
# the consistency loss. Run from the repository root:
#
#   bash toda_tpu_torch/tools/scripts/run_toda.sh <stage1_cfg> <pseudo_cfg> <stage2_cfg> [tag]
#
# DEVICE (default cuda) is passed to every CLI as --device; DEVICE=cpu runs
# the kernels' plain versions, e.g. on the tiny configs:
#
#   DEVICE=cpu bash toda_tpu_torch/tools/scripts/run_toda.sh \
#       toda_tpu_torch/tools/cfgs/toda_tiny/stage1.yaml \
#       toda_tpu_torch/tools/cfgs/toda_tiny/pseudo.yaml \
#       toda_tpu_torch/tools/cfgs/toda_tiny/stage2.yaml tiny
set -euo pipefail

STAGE1_CFG=$1
PSEUDO_CFG=$2
STAGE2_CFG=$3
TAG=${4:-toda}
DEVICE=${DEVICE:-cuda}
PY=${PYTHON:-python}

$PY -m toda_tpu_torch.tools.stage1_cutmix_train --cfg_file "$STAGE1_CFG" --extra_tag "$TAG" \
    --device "$DEVICE"

STAGE1_CKPT=$(ls output/*/"$(basename "$STAGE1_CFG" .yaml)"/"$TAG"/ckpt/checkpoint_epoch_*.pth \
    | sort -V | tail -1)

$PY -m toda_tpu_torch.tools.generate_pseudo_labels --cfg_file "$PSEUDO_CFG" \
    --ckpt "$STAGE1_CKPT" --perturb --score_thresh 0.2 \
    --output output/pseudo_infos_"$TAG".pkl --device "$DEVICE"

$PY -m toda_tpu_torch.tools.stage2_mixup_train_cl --cfg_file "$STAGE2_CFG" \
    --pseudo_info_path output/pseudo_infos_"$TAG".pkl \
    --pretrained_model "$STAGE1_CKPT" --extra_tag "$TAG" --device "$DEVICE"
