#!/usr/bin/env bash
# The config matrix and evolution at the flagship scale on the GPU, one run
# after another:
#   bench_table (17 rows), the NEAT flagship (pop 100, 50 generations, K=4
#   episodes of 512 steps), the ES canonical run (100 generations, pop 256,
#   sigma 0.03, lr 0.003, 32 validation episodes, a holdout of 256), and
#   last, only if LIMIT seconds (default 3000) leave room for it, the ES
#   broad search (60 generations, sigma 0.1, lr 0.01).
# The table and the curves go to artifacts/torch/ (checkpoints to
# artifacts/torch/ckpt/); each run's log, and a copy of the table and the
# curves, to LOGS.
#
#   bash marlsnake_torch/tools/flagship_runs.sh [LOGS [LIMIT]]   # default build/flagship
LOGS=${1:-build/flagship}
LIMIT=${2:-3000}
OUT=artifacts/torch
BROAD_S=720   # what the broad search is expected to take
mkdir -p "$LOGS" "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$LOGS/card.txt"
begin=$(date +%s)
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
    cp "$OUT"/BENCH_TABLE.json "$OUT"/*flagship*.jsonl "$OUT"/es_broadsearch*.jsonl "$LOGS"/ 2>/dev/null
}
run bench_table python -m marlsnake_torch.bench_table --out "$OUT/BENCH_TABLE.json"
run neat_flagship python -m marlsnake_torch.tools.neat_flagship --out "$OUT"
run es_flagship python -m marlsnake_torch.tools.es_flagship --out "$OUT"
elapsed=$(( $(date +%s) - begin ))
if [ $(( elapsed + BROAD_S )) -le "$LIMIT" ]; then
    run es_broadsearch python -m marlsnake_torch.tools.es_flagship --out "$OUT" \
        --curve es_broadsearch_curve.jsonl --generations 60 --sigma 0.1 --lr 0.01
else
    echo "es_broadsearch skipped: ${elapsed} s spent, ${BROAD_S} more would pass ${LIMIT}"
fi
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
exit $status
