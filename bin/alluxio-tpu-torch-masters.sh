#!/usr/bin/env bash
# Run a command on every host in conf/masters over ssh, with the PyTorch
# port's launchers (the counterpart of bin/alluxio-tpu-masters.sh;
# reference: bin/alluxio-masters.sh).
#
#   bin/alluxio-tpu-torch-masters.sh start      # start master+job-master
#   bin/alluxio-tpu-torch-masters.sh stop
#   bin/alluxio-tpu-torch-masters.sh cmd "uptime"
set -euo pipefail
SCRIPT_DIR="$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)"
# shellcheck source=bin/cluster-fanout-torch.sh
source "${SCRIPT_DIR}/cluster-fanout-torch.sh"
CONF_FILE="${ALLUXIO_TPU_MASTERS_FILE:-${REPO_DIR}/conf/masters}"
START_ROLES="master job_master"
STOP_ROLES="master job_master"
fanout_main "$@"
