#!/usr/bin/env bash
# The port's learning curves and its trained 4-way battle at full width on
# the GPU, one run after another (about 23 minutes on an H100):
#   the battle (128 episodes, a 16-step profiler window), run_ppo for seeds
#   0-2 (150 updates), run_dqn for seeds 0-2 (400 episodes), run_ppo20 for
#   seed 0 (1,200 updates).
# Curves and the table go to artifacts/torch/ (checkpoints to
# artifacts/torch/ckpt/); each run's log, and a copy of the curves and the
# table, to LOGS.
#
#   bash marlsnake_torch/examples/showcase_runs.sh [LOGS]   # default build/showcase
LOGS=${1:-build/showcase}
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
    tail -1 "$LOGS/$name.log" | cut -c1-600
    cp "$OUT"/*.jsonl "$OUT"/*.txt "$LOGS"/ 2>/dev/null
}
run battle python -m marlsnake_torch.tools.battle_batch_run --out "$OUT" --profile-steps 16
for s in 0 1 2; do
    run "ppo.seed$s" python -m marlsnake_torch.examples.train_showcase ppo --seed "$s" --out "$OUT"
done
for s in 0 1 2; do
    run "dqn.seed$s" python -m marlsnake_torch.examples.train_showcase dqn --seed "$s" --out "$OUT"
done
run ppo20.seed0 python -m marlsnake_torch.examples.train_showcase ppo20 --seed 0 --updates 1200 --out "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
exit $status
