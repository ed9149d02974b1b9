#!/usr/bin/env bash
#
# Shared core for the PyTorch port's cloud bootstrap actions (the
# counterpart of deploy/cloud/bootstrap-common.sh; reference:
# integration/dataproc/alluxio-dataproc.sh + integration/emr/alluxio-emr.sh
# — behavior parity, own implementation): install the alluxio-tpu wheel
# (it holds the port's package and its `alluxio-tpu-torch` console
# script), write site properties where the port's roles read them
# (ATPU_SITE_PROPERTIES, default /etc/alluxio_tpu/site.properties), and
# start the role's processes via `alluxio-tpu-torch`.
# `deploy/torch/cloud/build.sh` inlines this file into the per-cloud
# scripts so the uploaded artifact is self-contained (cloud init actions
# download exactly one file).
#
# Overridable for tests / air-gapped installs:
#   ATPU_SITE_PROPERTIES  site properties path (runtime contract: the
#                         port's shell reads this env var)
#   ATPU_WHEEL_URI        gs://, s3://, http(s):// or local wheel path
#                         (empty: pip install alluxio-tpu from the index);
#                         a fetched wheel keeps its file name, which pip
#                         needs
#   ATPU_ROOT_UFS         root UFS uri (required on masters)
#   ATPU_PROPERTIES       semicolon-separated extra k=v site properties
#   ATPU_LOG_DIR          daemon log dir (default /var/log/alluxio-tpu-torch)
#   ATPU_DRYRUN           1 = print the plan + write conf, never install
#                         or start processes (the test harness's mode)

set -eu

ATPU_SITE="${ATPU_SITE_PROPERTIES:-/etc/alluxio_tpu/site.properties}"
export ATPU_SITE_PROPERTIES="${ATPU_SITE}"
ATPU_LOG_DIR="${ATPU_LOG_DIR:-/var/log/alluxio-tpu-torch}"
ATPU_DRYRUN="${ATPU_DRYRUN:-0}"

log() { echo "[alluxio-tpu-torch-bootstrap] $*" >&2; }

run() {
  if [ "${ATPU_DRYRUN}" = "1" ]; then
    echo "PLAN: $*"
  else
    "$@"
  fi
}

run_daemon() {
  # $1: role subcommand of the `alluxio-tpu-torch` console script
  if [ "${ATPU_DRYRUN}" = "1" ]; then
    echo "PLAN: daemon alluxio-tpu-torch $1"
    return
  fi
  mkdir -p "${ATPU_LOG_DIR}"
  nohup alluxio-tpu-torch "$1" > "${ATPU_LOG_DIR}/$1.out" 2>&1 &
  echo $! > "${ATPU_LOG_DIR}/$1.pid"
  log "started alluxio-tpu-torch $1 (pid $(cat "${ATPU_LOG_DIR}/$1.pid"))"
}

append_site_property() {
  # keep the FIRST write of a key, matching the reference's
  # append_alluxio_property — operator-supplied extras are therefore
  # written BEFORE computed defaults so they win
  local property="$1" value="$2"
  if grep -qe "^\s*${property}=" "${ATPU_SITE}" 2>/dev/null; then
    log "property ${property} already set; keeping existing value"
  else
    echo "${property}=${value}" >> "${ATPU_SITE}"
  fi
}

write_site_properties() {
  # $1: master hostname
  mkdir -p "$(dirname "${ATPU_SITE}")"
  : > "${ATPU_SITE}"
  # operator extras FIRST: first-write-wins makes them authoritative
  local IFS=';'
  for kv in ${ATPU_PROPERTIES:-}; do
    [ -n "${kv}" ] || continue
    append_site_property "${kv%%=*}" "${kv#*=}"
  done
  unset IFS
  append_site_property "atpu.master.hostname" "$1"
  if [ -n "${ATPU_ROOT_UFS:-}" ]; then
    append_site_property "atpu.master.mount.table.root.ufs" \
      "${ATPU_ROOT_UFS}"
  fi
  # default worker MEM tier: half the host memory
  local mem_kb half_mb
  mem_kb="$(awk '/MemTotal/ {print $2}' /proc/meminfo)"
  half_mb="$((mem_kb / 2048))"
  append_site_property "atpu.worker.ramdisk.size" "${half_mb}MB"
  log "wrote $(wc -l < "${ATPU_SITE}") properties to ${ATPU_SITE}"
}

install_wheel() {
  # a fetched wheel keeps its own file name: pip reads the distribution,
  # version and tags from it
  local whl="/tmp/${ATPU_WHEEL_URI##*/}"
  case "${ATPU_WHEEL_URI:-}" in
    "")      run pip install alluxio-tpu ;;
    gs://*)  run gsutil cp "${ATPU_WHEEL_URI}" "${whl}"
             run pip install "${whl}" ;;
    s3://*)  run aws s3 cp "${ATPU_WHEEL_URI}" "${whl}"
             run pip install "${whl}" ;;
    http*)   run curl -fsSL -o "${whl}" "${ATPU_WHEEL_URI}"
             run pip install "${whl}" ;;
    *)       run pip install "${ATPU_WHEEL_URI}" ;;
  esac
}

start_role() {
  # $1: role (master|worker)
  case "$1" in
    master)
      run alluxio-tpu-torch format
      run_daemon master
      run_daemon job-master
      ;;
    worker)
      run_daemon worker
      run_daemon job-worker
      ;;
    *) log "unknown role '$1'"; exit 2 ;;
  esac
}

bootstrap() {
  # $1: master hostname; $2: role
  if [ -z "$1" ]; then
    log "FATAL: could not determine the master hostname"
    exit 2
  fi
  log "bootstrapping role=$2 master=$1 (dryrun=${ATPU_DRYRUN})"
  install_wheel
  write_site_properties "$1"
  start_role "$2"
  log "bootstrap complete"
}
