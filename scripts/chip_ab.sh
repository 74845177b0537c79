#!/usr/bin/env bash
# Parent against change on one card, in turns (P C C P): chip_smoke.py,
# then chip_smoke.py --profile, from a checkout of the parent commit and
# from this one.  Logs go to LOG_DIR/ab_<run>.log (default ab/logs).
#
#   mkdir -p ab/parent && git archive <parent> | tar -x -C ab/parent
#   bash scripts/chip_ab.sh ab/parent [LOG_DIR]
set -u
parent=${1:?usage: chip_ab.sh PARENT_CHECKOUT [LOG_DIR]}
here=$(cd "$(dirname "$0")/.." && pwd)
logs=$(mkdir -p "${2:-$here/ab/logs}" && cd "${2:-$here/ab/logs}" && pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
run() {  # tag dir [args]
  local tag=$1 dir=$2
  shift 2
  (cd "$dir" && python3 chip_smoke.py "$@") > "$logs/ab_$tag.log" 2>&1
  echo "$tag rc=$?"
  nvidia-smi --query-gpu=name,power.limit,clocks.sm --format=csv,noheader
}
for args in "" "--profile"; do
  kind=${args:+prof}
  kind=${kind:-smoke}
  run "${kind}_p1" "$parent" $args
  run "${kind}_c1" "$here" $args
  run "${kind}_c2" "$here" $args
  run "${kind}_p2" "$parent" $args
done
