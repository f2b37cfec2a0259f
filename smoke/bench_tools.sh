#!/usr/bin/env bash
# The port's load and latency tools at their default commands on the card,
# one process each, in turn:
#
#   bash smoke/bench_tools.sh [OUT_DIR] [TOOL ...]
#
# OUT_DIR (default smoke/_build/bench_tools) gets each tool's stdout and
# stderr (<tool>.out, <tool>.err) and card.txt; this script prints, per
# tool, one {"tool", "args", "rc", "seconds"} line and the tool's last
# stdout line (its JSON record). The first tool builds the kernels (the
# later ones load the same build). serve_bench runs at --tp 1: its default
# --tp 2 does not divide the one card's world of one rank (it raises).
# Exits 1 when a tool failed; every tool runs either way.
set -u
out=${1:-smoke/_build/bench_tools}
shift || true
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$out/card.txt"
python3 -c 'import sys, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda)'

declare -A ARGS=(
  [throughput_bench]=""
  [continuous_bench]="16 32"
  [graph_bench]="--model turbo"
  [trace_ops]="turbo 10 --what decode"
  [streaming_latency]=""
  [soak_server]=""
  [spec_bench]=""
  [serve_bench]="--model turbo --tp 1"
)
tools=("$@")
if [ ${#tools[@]} -eq 0 ]; then
  tools=(throughput_bench continuous_bench graph_bench trace_ops streaming_latency soak_server spec_bench serve_bench)
fi

failed=0
for tool in "${tools[@]}"; do
  start=$(date +%s.%N)
  # shellcheck disable=SC2086
  python3 -m "whisper_tpu_torch.$tool" ${ARGS[$tool]} > "$out/$tool.out" 2> "$out/$tool.err"
  rc=$?
  end=$(date +%s.%N)
  echo "{\"tool\": \"$tool\", \"args\": \"${ARGS[$tool]}\", \"rc\": $rc, \"seconds\": $(awk "BEGIN {print $end - $start}")}"
  tail -n 1 "$out/$tool.out" | cut -c1-3000
  if [ $rc -ne 0 ]; then
    failed=1
    tail -n 20 "$out/$tool.err"
  fi
done
exit $failed
