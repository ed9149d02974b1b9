#!/usr/bin/env bash
#
# Dataproc initialization action for the PyTorch port (the counterpart of
# deploy/dataproc/alluxio-tpu-dataproc.sh; reference:
# integration/dataproc/alluxio-dataproc.sh — same job, own script):
#
# Upload the BUILT artifact (deploy/cloud/build.sh inlines the common
# core so the uploaded file is self-contained — init actions download
# exactly one file):
#
#   bash deploy/torch/cloud/build.sh
#   gsutil cp deploy/torch/dist/alluxio-tpu-torch-dataproc.sh gs://<bucket>/
#   gcloud dataproc clusters create my-cluster \
#     --initialization-actions gs://<bucket>/alluxio-tpu-torch-dataproc.sh \
#     --metadata atpu_root_ufs=gs://my-bucket/warehouse \
#     --metadata atpu_wheel_uri=gs://my-bucket/alluxio_tpu-0.1.0-py3-none-any.whl \
#     --metadata atpu_site_properties='atpu.worker.ramdisk.size=32GB'
#
# Role + master come from the Dataproc VM metadata server; every knob
# can be overridden by env for tests (see bootstrap-common.sh).

set -eu

# >>> bootstrap-common.sh (replaced inline by deploy/torch/cloud/build.sh) >>>
HERE="$(cd "$(dirname "$0")" && pwd)"
. "${HERE}/../cloud/bootstrap-common.sh"
# <<< bootstrap-common.sh <<<

metadata() {
  # $1: key, $2: default; env override ATPU_MD_<KEY> wins (tests)
  local env_key="ATPU_MD_$(echo "$1" | tr 'a-z-' 'A-Z_')"
  local override
  override="$(eval "echo \"\${${env_key}:-}\"")"
  if [ -n "${override}" ]; then
    echo "${override}"
  elif [ -x /usr/share/google/get_metadata_value ]; then
    /usr/share/google/get_metadata_value "attributes/$1" || echo "$2"
  else
    echo "$2"
  fi
}

ROLE_RAW="$(metadata dataproc-role Worker)"
MASTER="$(metadata dataproc-master localhost)"
ATPU_ROOT_UFS="${ATPU_ROOT_UFS:-$(metadata atpu_root_ufs "")}"
ATPU_WHEEL_URI="${ATPU_WHEEL_URI:-$(metadata atpu_wheel_uri "")}"
ATPU_PROPERTIES="${ATPU_PROPERTIES:-$(metadata atpu_site_properties "")}"
export ATPU_ROOT_UFS ATPU_WHEEL_URI ATPU_PROPERTIES

case "${ROLE_RAW}" in
  Master) ROLE=master ;;
  *)      ROLE=worker ;;
esac

bootstrap "${MASTER}" "${ROLE}"
