#!/usr/bin/env bash
# Run a command on every host in conf/workers over ssh, with the PyTorch
# port's launchers (the counterpart of bin/alluxio-tpu-workers.sh;
# reference: bin/alluxio-workers.sh).
#
#   bin/alluxio-tpu-torch-workers.sh start      # start worker+job-worker
#   bin/alluxio-tpu-torch-workers.sh stop
#   bin/alluxio-tpu-torch-workers.sh cmd "uptime"
set -euo pipefail
SCRIPT_DIR="$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)"
# shellcheck source=bin/cluster-fanout-torch.sh
source "${SCRIPT_DIR}/cluster-fanout-torch.sh"
CONF_FILE="${ALLUXIO_TPU_WORKERS_FILE:-${REPO_DIR}/conf/workers}"
START_ROLES="worker job_worker"
STOP_ROLES="worker job_worker"
fanout_main "$@"
