#!/bin/bash
# The stage splits of PERF.md section 5, one process per column, on one GPU:
#     bash perf/stages_all.sh [output directory, default chiprun_out]
# Each run writes stages_<name>.json; a summary line per file follows.  The
# oneBD hardcore counts fit runs twice, first and last, to show how far the
# host's clock swings between processes of one call.
set -e
OUT=${1:-chiprun_out}
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
run() {  # name, then the arguments of utils.stages
    local name=$1; shift
    python -m mcmctoffitting_tpu_torch.utils.stages "$@" \
        --out "$OUT/stages_$name.json" > /dev/null
}
run onebd_hardcore_counts --model onebd --hardcore --sampling counts
run onebd_mc --model onebd --sampling mc --reps 10
run onebd_counts --model onebd --sampling counts
run onebd_expected --model onebd --sampling expected
run simult_counts --model simult --sampling counts
run simult_expected --model simult --sampling expected
run simult_mc_default --model simult --sampling mc --reps 10
run simult_mc_table_taylor --model simult --sampling mc --xs-mode taylor \
    --reps 5 --steps 4 --profile-steps 2
run simult_mc_table_exact --model simult --sampling mc --xs-mode exact \
    --reps 3 --steps 2 --profile-steps 1
run simult_mc_rk4_taylor --model simult --sampling mc --transport rk4 \
    --xs-mode taylor --reps 10
run simult_mc_rk4_exact --model simult --sampling mc --transport rk4 \
    --xs-mode exact --likelihood poisson --reps 5 --steps 4 --profile-steps 1
run onebd_hardcore_counts_2 --model onebd --hardcore --sampling counts
python - "$OUT" <<'PY'
import glob, json, sys
keys = ("card", "log_prob_ms", "step_ms", "profiled_step_ms",
        "walker_steps_per_s", "device_ms_per_step", "device_ops_per_step",
        "device_window_ms_per_step", "device_busy_share", "build_seconds")
for path in sorted(glob.glob(sys.argv[1] + "/stages_*.json")):
    d = json.load(open(path))
    print(path, {k: d[k] for k in keys if k in d})
    for split in ("stages_ms", "stages_sync_ms"):
        print(split, {n: round(v["total_ms"], 4)
                      for n, v in d[split].items()})
    print(d["top_kernels_ms_per_step"])
PY
