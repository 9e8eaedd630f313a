#!/bin/bash
# The fine-cell moment stage of mc on the stopping table (simultFit's
# default and oneBD's mc) before and after a change, on one GPU, in turns
# (parent, change, change, parent), one process each:
#     mkdir -p build/parent && git archive <parent> | tar -x -C build/parent
#     bash perf/moments_before_after.sh build/parent [output directory]
# Writes moments_<model>_<tree>_<turn>.json (the utils.stages JSON) and
# prints, per run, the card, the stage's ms per half-step, the plain eval,
# ms per DE step, walker-steps/s and the device's busy share.
set -e
PARENT=$1
OUT=${2:-chiprun_out}
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
run() {  # tree directory, label, turn, model
    (cd "$1" && python -m mcmctoffitting_tpu_torch.utils.stages \
        --model "$4" --sampling mc --reps 10 \
        --out "$OLDPWD/$OUT/moments_$4_$2_$3.json" > /dev/null)
}
for model in simult onebd; do
    run "$PARENT" parent 1 $model
    run . change 1 $model
    run . change 2 $model
    run "$PARENT" parent 2 $model
done
python - "$OUT" <<'PY'
import glob, json, sys
for path in sorted(glob.glob(sys.argv[1] + "/moments_*.json")):
    d = json.load(open(path))
    stage = {k: v for k, v in d["stages_ms"].items() if "fine-cell" in k}
    print(path, d["card"], stage, {k: d[k] for k in (
        "log_prob_ms", "step_ms", "walker_steps_per_s",
        "device_ms_per_step", "device_busy_share")})
PY
