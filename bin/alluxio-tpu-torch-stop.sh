#!/usr/bin/env bash
# Stop background roles started by alluxio-tpu-torch-start.sh (the
# counterpart of bin/alluxio-tpu-stop.sh).
# Usage: bin/alluxio-tpu-torch-stop.sh <master|worker|job_master|job_worker|proxy|all>
#
# ALLUXIO_TPU_PID_DIR names the pid directory; its default,
# ${TMPDIR:-/tmp}/alluxio-tpu-torch-pids, is the port's own, so `all`
# leaves the JAX package's roles (/tmp/alluxio-tpu-pids) running.
set -euo pipefail
PID_DIR="${ALLUXIO_TPU_PID_DIR:-${TMPDIR:-/tmp}/alluxio-tpu-torch-pids}"

stop_role() {
  local pid_file="${PID_DIR}/$1.pid"
  if [[ -f "${pid_file}" ]]; then
    local pid
    pid="$(cat "${pid_file}")"
    if kill "${pid}" 2>/dev/null; then
      echo "Stopped $1 (pid ${pid})"
    else
      echo "$1 (pid ${pid}) was not running"
    fi
    rm -f "${pid_file}"
  else
    echo "No pid file for $1"
  fi
}

case "${1:-}" in
  master|worker|job_master|job_worker|proxy) stop_role "$1" ;;
  all) for r in job_worker job_master worker proxy master; do stop_role "$r"; done ;;
  *) echo "Usage: $0 <master|worker|job_master|job_worker|proxy|all>"; exit 1 ;;
esac
