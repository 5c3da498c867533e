#!/usr/bin/env bash
# Round-3 recall-coverage sweep: eval-time SEAR knobs that grow the
# candidate pool itself. Motivation: the w1.0 run measured
# recall@1000 == recall@300 (0.7851) — the pool is saturated, so only
# search-side coverage (more subdivision, wider frontier, overlapping
# divisions) can reach the missed partially-occluded mid-size objects.
# Reference parity note: the reference sweeps only NUM_PROPOSALS
# (paper N in {100,300,1000}); these knobs are eval-time config in both
# designs (SURVEY.md §5.6; mount empty, no file:line exists).
# Usage: ./experiments/scripts/recall_coverage_sweep.sh [CKPT] [IMDB]
set -uo pipefail
cd "$(dirname "$0")/../.."
LOG="experiments/logs/recall_sweep_$(date +%Y%m%d_%H%M%S).log"
exec &> >(tee "$LOG")
CFG=${CFG:-experiments/cfgs/az_vgg_w100_synthetic_hard.yml}
CKPT=${1:-output/quality_r3_w100/az}
IMDB=${2:-synthetic_hard_test}

run() {
  local name="$1"; shift
  echo "=== sweep: $name  ($*)"
  if [ "$#" -gt 0 ]; then
    python tools/test_net.py --mode recall --imdb "$IMDB" --cfg "$CFG" \
        --ckpt "$CKPT" --batched --set "$@"
  else
    python tools/test_net.py --mode recall --imdb "$IMDB" --cfg "$CFG" \
        --ckpt "$CKPT" --batched
  fi
}

run baseline
run zoom_0.10      SEAR.ZOOM_THRESH 0.10
run zoom_0.05      SEAR.ZOOM_THRESH 0.05
run div_overlap    SEAR.DIV_OVERLAP 0.25
run frontier_128   SEAR.FRONTIER_CAP 128
run seed_2         SEAR.SEED_LEVELS 2
run combo          SEAR.ZOOM_THRESH 0.05 SEAR.DIV_OVERLAP 0.25 SEAR.FRONTIER_CAP 128
