#!/usr/bin/env bash
#
# EMR bootstrap action for the PyTorch port (the counterpart of
# deploy/emr/alluxio-tpu-emr.sh; reference: integration/emr/alluxio-emr.sh
# — same job, own script):
#
# Upload the BUILT artifact (deploy/cloud/build.sh inlines the common
# core so the uploaded file is self-contained):
#
#   bash deploy/torch/cloud/build.sh
#   aws s3 cp deploy/torch/dist/alluxio-tpu-torch-emr.sh s3://<bucket>/
#   aws emr create-cluster ... \
#     --bootstrap-actions Path=s3://<bucket>/alluxio-tpu-torch-emr.sh,\
#       Args=[s3://my-bucket/warehouse,s3://my-bucket/alluxio_tpu-0.1.0-py3-none-any.whl]
#
#   $1: root UFS uri (optional)
#   $2: wheel uri (optional)
#   $3: extra site properties "k=v;k2=v2" (optional)
#
# EMR's instance.json distinguishes master from core/task nodes; the
# master's private DNS comes from job-flow.json. Both paths honor env
# overrides for tests (ATPU_EMR_IS_MASTER / ATPU_EMR_MASTER_HOST).

set -eu

# >>> bootstrap-common.sh (replaced inline by deploy/torch/cloud/build.sh) >>>
HERE="$(cd "$(dirname "$0")" && pwd)"
. "${HERE}/../cloud/bootstrap-common.sh"
# <<< bootstrap-common.sh <<<

ATPU_ROOT_UFS="${ATPU_ROOT_UFS:-${1:-}}"
ATPU_WHEEL_URI="${ATPU_WHEEL_URI:-${2:-}}"
ATPU_PROPERTIES="${ATPU_PROPERTIES:-${3:-}}"
export ATPU_ROOT_UFS ATPU_WHEEL_URI ATPU_PROPERTIES

is_master() {
  if [ -n "${ATPU_EMR_IS_MASTER:-}" ]; then
    [ "${ATPU_EMR_IS_MASTER}" = "true" ]
  else
    grep -q '"isMaster"[[:space:]]*:[[:space:]]*true' \
      /mnt/var/lib/info/instance.json
  fi
}

master_host() {
  if [ -n "${ATPU_EMR_MASTER_HOST:-}" ]; then
    echo "${ATPU_EMR_MASTER_HOST}"
  else
    # masterPrivateDnsName in job-flow.json
    sed -n 's/.*"masterPrivateDnsName"[[:space:]]*:[[:space:]]*"\([^"]*\)".*/\1/p' \
      /mnt/var/lib/info/job-flow.json | head -1
  fi
}

if is_master; then
  bootstrap "$(hostname -f)" master
else
  MH="$(master_host)"
  if [ -z "${MH}" ]; then
    echo "[alluxio-tpu-torch-bootstrap] FATAL: no masterPrivateDnsName in" \
         "job-flow.json — refusing to start a worker at localhost" >&2
    exit 2
  fi
  bootstrap "${MH}" worker
fi
