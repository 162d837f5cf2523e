#!/usr/bin/env bash
# Multi-host launcher (the reference's planned launch_eval.sh,
# .gitignore:146-147). Run ONE copy per host; every copy must see the same
# coordinator address and the cluster-wide process count:
#
#   TPUMCIA_COORDINATOR=host0:8476 TPUMCIA_NUM_PROCESSES=4 \
#   TPUMCIA_PROCESS_ID=$(hostname_index) ./launch_eval.sh --source h5 --data /data
#
# The three variables are required: nothing is auto-detected. All arguments
# are forwarded to `python -m tpumcia.eval` (plus --distributed).
set -euo pipefail
cd "$(dirname "$0")"
exec python -m tpumcia.eval --config configs/sample_config.json --distributed "$@"
