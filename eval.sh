#!/usr/bin/env bash
# Config-driven evaluation (the reference's planned eval.sh, SURVEY.md §0.2).
# Usage: ./eval.sh [--source h5|folder|synthetic] [--data DIR] [...]
set -euo pipefail
cd "$(dirname "$0")"
exec python -m tpumcia.eval --config configs/sample_config.json "$@"
