#!/usr/bin/env bash
# The DAgger distillation and the two rollout demos on the GPU, one run
# after another:
#   the distillation at the JAX tool's defaults (conv 16,32, fc 64, 60
#   iterations of 256 envs) into LOGS/small; at the committed student's
#   counts (conv 32,64, fc 128, 200 iterations of 256 envs) into
#   artifacts/torch (its meta; the student to artifacts/torch/ckpt/);
#   examples/demo.py (1024 envs x 256 steps) and examples/vector_rollout.py
#   (4096 envs x 256 steps) at their defaults.
# Each run's log goes to LOGS, with a copy of the committed meta and of
# the student it describes.
#
#   bash marlsnake_torch/tools/distill_runs.sh [LOGS]   # default build/distill
LOGS=${1:-build/distill}
OUT=artifacts/torch
mkdir -p "$LOGS" "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$LOGS/card.txt"
status=0
run() {
    local name=$1 start rc
    shift
    start=$(date +%s)
    "$@" > "$LOGS/$name.log" 2>&1
    rc=$?
    [ $rc -eq 0 ] || status=$rc
    echo "$name rc=$rc $(( $(date +%s) - start )) s"
    tail -1 "$LOGS/$name.log" | cut -c1-800
}
run distill_small python -m marlsnake_torch.tools.distill_acting --out "$LOGS/small"
run distill python -m marlsnake_torch.tools.distill_acting 200 256 32,64 128
cp "$OUT"/distilled_acting.msgpack.meta.json "$OUT"/ckpt/distilled_acting.msgpack "$LOGS"/
run demo python -m marlsnake_torch.examples.demo
run vector_rollout python -m marlsnake_torch.examples.vector_rollout
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
exit $status
