#!/usr/bin/env bash
# Prepare the PyTorch port's worker MEM-tier ramdisk (the counterpart of
# bin/alluxio-tpu-mount.sh; reference: bin/alluxio-mount.sh). The ramdisk
# size and the tier-0 directory are read through alluxio_tpu_torch.conf,
# from the same atpu.* keys: the ATPU_* variables, then the site file that
# ATPU_SITE_PROPERTIES names (the JAX script reads the variables only).
#
# Usage: alluxio-tpu-torch-mount.sh [Mount|SudoMount|Umount|SudoUmount|Check] [workers]
#   Mount      mount a tmpfs of atpu.worker.ramdisk.size at the level0
#              dir (no-op if the dir already sits on tmpfs with space)
#   SudoMount  same, via sudo (needed unless running as root)
#   Umount     unmount it
#   Check      report what is mounted where (never changes anything)
#   workers    run the chosen action on every host in conf/workers
set -euo pipefail
SCRIPT_DIR="$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)"
REPO_DIR="$(dirname "${SCRIPT_DIR}")"
export PYTHONPATH="${REPO_DIR}${PYTHONPATH:+:${PYTHONPATH}}"
PY="${PYTHON:-python3}"

ACTION="${1:-Mount}"
TARGET="${2:-local}"

conf_get() {
  "${PY}" - "$1" <<'EOF'
import sys
from alluxio_tpu_torch.conf import Keys, Templates, site_configuration
conf = site_configuration()
key = sys.argv[1]
if key == "ramdisk_bytes":
    print(conf.get_bytes(Keys.WORKER_RAMDISK_SIZE))
elif key == "tier0_dir":
    dirs = conf.get_list(Templates.WORKER_TIER_DIRS_PATH.format(0)) or []
    print(dirs[0] if dirs else "/dev/shm/alluxio-tpu")
elif key == "tier0_alias":
    print(conf.get(Templates.WORKER_TIER_ALIAS.format(0)) or "MEM")
EOF
}

if [[ "${TARGET}" == "workers" ]]; then
  CONF_FILE="${ATPU_CONF_DIR:-${REPO_DIR}/conf}/workers"
  # shellcheck source=cluster-fanout-torch.sh
  . "${SCRIPT_DIR}/cluster-fanout-torch.sh"
  fanout "${REPO_DIR}/bin/alluxio-tpu-torch-mount.sh ${ACTION}"
  exit $?
fi

RAMDISK_BYTES="$(conf_get ramdisk_bytes)"
TIER_DIR="$(conf_get tier0_dir)"
ALIAS="$(conf_get tier0_alias)"

is_tmpfs() {
  [[ "$(df --output=fstype "$1" 2>/dev/null | tail -1)" == tmpfs ]]
}

case "${ACTION}" in
  Check)
    echo "tier0 (${ALIAS}): ${TIER_DIR} (want ${RAMDISK_BYTES} B)"
    df -h "${TIER_DIR}" 2>/dev/null || echo "  not present"
    ;;
  Mount|SudoMount)
    SUDO=""
    [[ "${ACTION}" == "SudoMount" ]] && SUDO="sudo"
    if [[ "${ALIAS}" != "MEM" ]]; then
      echo "tier0 alias is ${ALIAS}, not MEM — nothing to mount"
      exit 0
    fi
    total_mem=$(( $(awk 'NR==1{print $2}' /proc/meminfo) * 1024 ))
    if (( total_mem < RAMDISK_BYTES )); then
      echo "ERROR: ramdisk ${RAMDISK_BYTES} B exceeds host memory ${total_mem} B" >&2
      exit 1
    fi
    ${SUDO} mkdir -p "${TIER_DIR}"
    if is_tmpfs "${TIER_DIR}"; then
      echo "${TIER_DIR} already on tmpfs; leaving it"
      exit 0
    fi
    ${SUDO} mount -t tmpfs -o "size=${RAMDISK_BYTES}" tmpfs "${TIER_DIR}"
    echo "mounted tmpfs (${RAMDISK_BYTES} B) at ${TIER_DIR}"
    ;;
  Umount|SudoUmount)
    SUDO=""
    [[ "${ACTION}" == "SudoUmount" ]] && SUDO="sudo"
    if is_tmpfs "${TIER_DIR}"; then
      ${SUDO} umount "${TIER_DIR}"
      echo "unmounted ${TIER_DIR}"
    else
      echo "${TIER_DIR} is not a tmpfs mount; nothing to do"
    fi
    ;;
  *)
    echo "Usage: alluxio-tpu-torch-mount.sh [Mount|SudoMount|Umount|SudoUmount|Check] [workers]" >&2
    exit 2
    ;;
esac
