#!/bin/bash
# Orchestration script — mirrors the reference's runme.sh flow
# (SURVEY.md §2 "Orchestration script", §1 L6):
#   1. feature packing → 2. train per model type → 3. threshold
#   optimization + final metrics → 4. plots.
#
# With the real DCASE 2017 Task 4 distribution, set DATASET_DIR to its root
# (audio/<split>/*.wav + metadata/<split>_set.csv). Without it, the script
# builds a synthetic corpus with the same layout so the whole pipeline runs
# self-contained.
set -euo pipefail

DATASET_DIR="${DATASET_DIR:-}"
WORKSPACE="${WORKSPACE:-./workspace}"
PKG="sound_event_detection_dcase2017_task4_torch"
MODEL_TYPES=("Cnn_9layers_AvgPooling" "Cnn_9layers_AttPooling" \
             "Cnn_9layers_Glu_AttPooling" "Cnn_9layers_Gru_FrameAtt")
BATCH_SIZE=${BATCH_SIZE:-32}
STOP_ITERATION=${STOP_ITERATION:-10000}

############ 1. Pack features ############
if [ -z "$DATASET_DIR" ]; then
  echo "DATASET_DIR unset → building synthetic corpus (SYNTH_PROFILE=${SYNTH_PROFILE:-easy})"
  python -m $PKG.features pack_synthetic --workspace=$WORKSPACE \
      --num_train=200 --num_test=40 --num_eval=40 --use_pallas --metadata_only \
      --profile="${SYNTH_PROFILE:-easy}"
  DATASET_DIR="$WORKSPACE/synth_dataset"
else
  for SPLIT in training testing evaluation; do
    python -m $PKG.features calculate_feature_for_all_audio_files \
        --dataset_dir=$DATASET_DIR --workspace=$WORKSPACE \
        --data_type=$SPLIT --use_pallas
  done
  python -m $PKG.features calculate_scalar --workspace=$WORKSPACE
fi

############ 2. Train ############
for MODEL_TYPE in "${MODEL_TYPES[@]}"; do
  python -m $PKG.main train \
      --workspace=$WORKSPACE --dataset_dir=$DATASET_DIR \
      --model_type=$MODEL_TYPE --loss_type=clip_bce --augmentation=mixup \
      --batch_size=$BATCH_SIZE --stop_iteration=$STOP_ITERATION \
      --feature_source=waveform
done

############ 3. Thresholds + final metrics ############
for MODEL_TYPE in "${MODEL_TYPES[@]}"; do
  # NB: --augmentation (and any other run-config knob) must match stage 2,
  # since it keys the checkpoint/prediction paths.
  for SPLIT in testing evaluation; do
    python -m $PKG.main inference --workspace=$WORKSPACE \
        --dataset_dir=$DATASET_DIR --model_type=$MODEL_TYPE \
        --augmentation=mixup --batch_size=$BATCH_SIZE --data_type=$SPLIT \
        --feature_source=waveform
  done
  python -m $PKG.main optimize_at_thresholds --workspace=$WORKSPACE \
      --dataset_dir=$DATASET_DIR --model_type=$MODEL_TYPE \
      --augmentation=mixup --batch_size=$BATCH_SIZE
  python -m $PKG.main optimize_sed_thresholds --workspace=$WORKSPACE \
      --dataset_dir=$DATASET_DIR --model_type=$MODEL_TYPE \
      --augmentation=mixup --batch_size=$BATCH_SIZE
  python -m $PKG.main calculate_metrics --workspace=$WORKSPACE \
      --dataset_dir=$DATASET_DIR --model_type=$MODEL_TYPE \
      --augmentation=mixup --batch_size=$BATCH_SIZE \
      --data_type=evaluation --use_optimized_thresholds
done

############ 4. Plots ############
python -m $PKG.plot_results --workspace=$WORKSPACE --out=$WORKSPACE/results.png
