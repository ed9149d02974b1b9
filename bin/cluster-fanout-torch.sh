#!/usr/bin/env bash
# Shared ssh fan-out helper sourced by alluxio-tpu-torch-{masters,workers}.sh
# and alluxio-tpu-torch-mount.sh: the counterpart of cluster-fanout.sh that
# starts and stops the PyTorch port's roles
# (reference: libexec/alluxio-config.sh + bin/alluxio-{masters,workers}.sh).
# The sourcing script sets: CONF_FILE, START_ROLES, STOP_ROLES.
set -euo pipefail
SCRIPT_DIR="$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)"
REPO_DIR="$(dirname "${SCRIPT_DIR}")"
SSH_OPTS="${ALLUXIO_TPU_SSH_OPTS:--o ConnectTimeout=5 -o StrictHostKeyChecking=no}"

fanout() {
  local remote_cmd="$1"
  if [[ ! -f "${CONF_FILE}" ]]; then
    echo "No ${CONF_FILE}; list one hostname per line." >&2
    return 1
  fi
  local pids=()
  # `|| [[ -n ... ]]` keeps a final unterminated line; `ssh -n` stops
  # the backgrounded ssh from draining the conf file off shared stdin
  while IFS= read -r host || [[ -n "${host}" ]]; do
    [[ -z "${host}" || "${host}" == \#* ]] && continue
    echo "[${host}] ${remote_cmd}"
    # shellcheck disable=SC2086
    ssh -n ${SSH_OPTS} "${host}" "${remote_cmd}" &
    pids+=($!)
  done < "${CONF_FILE}"
  local rc=0
  for pid in "${pids[@]}"; do wait "${pid}" || rc=1; done
  return ${rc}
}

fanout_main() {
  case "${1:-}" in
    start)
      local cmd="cd ${REPO_DIR}"
      local role
      for role in ${START_ROLES}; do
        cmd+=" && bin/alluxio-tpu-torch-start.sh ${role}"
      done
      fanout "${cmd}"
      ;;
    stop)
      local cmd="cd ${REPO_DIR}"
      local role
      for role in ${STOP_ROLES}; do
        cmd+="; bin/alluxio-tpu-torch-stop.sh ${role}"
      done
      fanout "${cmd}"
      ;;
    cmd)
      shift
      fanout "$*"
      ;;
    *) echo "Usage: $0 <start|stop|cmd '<command>'>"; exit 1 ;;
  esac
}
