#!/usr/bin/env bash
# Build the PyTorch port's self-contained bootstrap artifacts for upload
# into deploy/torch/dist/ (the counterpart of deploy/cloud/build.sh;
# reference: integration/{dataproc,emr}/build.sh): the per-cloud scripts
# source bootstrap-common.sh in the repo; cloud init actions download ONE
# file, so this inlines the common core between the >>> <<< sentinels.
set -eu
HERE="$(cd "$(dirname "$0")" && pwd)"
DEPLOY="$(dirname "${HERE}")"
DIST="${DEPLOY}/dist"
mkdir -p "${DIST}"

inline() {
  # $1: source script, $2: output
  awk -v common="${HERE}/bootstrap-common.sh" '
    /^# >>> bootstrap-common.sh/ {
      print "# ---- inlined deploy/torch/cloud/bootstrap-common.sh ----";
      while ((getline line < common) > 0) print line;
      close(common); skipping = 1; next
    }
    /^# <<< bootstrap-common.sh/ { skipping = 0; next }
    !skipping { print }
  ' "$1" > "$2"
  chmod +x "$2"
  echo "built $2"
}

inline "${DEPLOY}/dataproc/alluxio-tpu-torch-dataproc.sh" \
       "${DIST}/alluxio-tpu-torch-dataproc.sh"
inline "${DEPLOY}/emr/alluxio-tpu-torch-emr.sh" \
       "${DIST}/alluxio-tpu-torch-emr.sh"
