#!/usr/bin/env bash
# Start the PyTorch port's cluster roles in the background (the
# counterpart of bin/alluxio-tpu-start.sh; reference: bin/alluxio-start.sh).
# Usage: bin/alluxio-tpu-torch-start.sh <master|worker|job_master|job_worker|proxy|local>
# `local` starts master + worker + job master + job worker on this host.
#
# ALLUXIO_TPU_LOGS_DIR and ALLUXIO_TPU_PID_DIR name the log and pid
# directories, as for the JAX package's scripts. Their defaults differ on
# purpose: ${TMPDIR:-/tmp}/alluxio-tpu-torch-{logs,pids}, so that the
# port's `stop all` on a host that also runs the JAX package's roles
# never reads their pid files. Roles read their conf from
# ATPU_SITE_PROPERTIES and ATPU_* variables.
set -euo pipefail
SCRIPT_DIR="$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)"
LOG_DIR="${ALLUXIO_TPU_LOGS_DIR:-${TMPDIR:-/tmp}/alluxio-tpu-torch-logs}"
PID_DIR="${ALLUXIO_TPU_PID_DIR:-${TMPDIR:-/tmp}/alluxio-tpu-torch-pids}"
mkdir -p "${LOG_DIR}" "${PID_DIR}"

start_role() {
  local role="$1"
  local cli_role="${role//_/-}"
  nohup "${SCRIPT_DIR}/alluxio-tpu-torch" "${cli_role}" \
    >"${LOG_DIR}/${role}.out" 2>&1 &
  echo $! > "${PID_DIR}/${role}.pid"
  echo "Started ${role} (pid $(cat "${PID_DIR}/${role}.pid")), logs in ${LOG_DIR}/${role}.out"
}

case "${1:-}" in
  master|worker|job_master|job_worker|proxy) start_role "$1" ;;
  local)
    start_role master; sleep 2
    start_role worker
    start_role job_master; sleep 1
    start_role job_worker
    ;;
  *) echo "Usage: $0 <master|worker|job_master|job_worker|proxy|local>"; exit 1 ;;
esac
