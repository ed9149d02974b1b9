"""Foreground role launchers (a copy of
``alluxio_tpu/shell/launch.py``).

Re-design of the reference's role mains (``master/AlluxioMaster.java:35``,
``worker/AlluxioWorker.java:44``, ``master/AlluxioJobMasterProcess.java``,
``proxy/AlluxioProxy.java:37``) plus ``bin/alluxio-start.sh``'s
launch-process: build the process from the configuration, serve until
SIGINT/SIGTERM, then stop it.

The roles are host processes: none of them imports torch, and none
touches the card. ``atpu.master.ha.enabled`` launches the HA master
(``FaultTolerantMasterProcess``: a standby until it wins primacy). A
launched master, HA or not, attaches the replication checker and the
persistence scheduler to the job master its conf names whenever it
serves as primary (the JAX master arm never does). Every role but the
log server ships its records to the log server when
``atpu.logserver.hostname`` is set. A FUSE launcher on a host without
``libfuse.so.2`` or ``/dev/fuse`` also logs its refusal (the JAX arm
only prints it), so that the log server shows why the mount is missing.
"""

from __future__ import annotations

import logging
import signal
import socket
import threading

from alluxio_tpu_torch.conf import Configuration, Keys

LOG = logging.getLogger(__name__)


def _serve_until_signal(stop_fn, banner: str) -> int:
    done = threading.Event()

    def _handler(signum, frame):
        done.set()

    signal.signal(signal.SIGINT, _handler)
    signal.signal(signal.SIGTERM, _handler)
    LOG.info("%s", banner)
    print(banner, flush=True)
    done.wait()
    stop_fn()
    return 0


def _master_address(conf: Configuration) -> str:
    addresses = conf.get(Keys.MASTER_RPC_ADDRESSES)
    if addresses:
        return str(addresses)
    return (f"{conf.get(Keys.MASTER_HOSTNAME)}:"
            f"{conf.get_int(Keys.MASTER_RPC_PORT)}")


def launch_master(conf: Configuration) -> int:
    if conf.get_bool(Keys.MASTER_HA_ENABLED):
        from alluxio_tpu_torch.master.process import (
            FaultTolerantMasterProcess,
        )

        proc = FaultTolerantMasterProcess(conf, attach_job_service=True)
        proc.start()
        banner = ("alluxio-tpu master started (HA): "
                  + ("serving" if proc.serving else "standby, tailing")
                  + f" (journal replay {proc.replay_s:.6f} s)")
        return _serve_until_signal(proc.stop, banner)
    from alluxio_tpu_torch.master.process import MasterProcess

    proc = MasterProcess(conf, attach_job_service=True)
    port = proc.start()
    return _serve_until_signal(
        proc.stop, f"alluxio-tpu master serving on port {port} "
                   f"(journal replay {proc.replay_s:.6f} s)")


def launch_worker(conf: Configuration) -> int:
    from alluxio_tpu_torch.rpc.clients import (
        BlockMasterClient, FsMasterClient, MetaMasterClient,
    )
    from alluxio_tpu_torch.rpc.core import RpcServer
    from alluxio_tpu_torch.rpc.worker_service import worker_service
    from alluxio_tpu_torch.worker.process import BlockWorker
    from alluxio_tpu_torch.worker.ufs_manager import WorkerUfsManager

    master_addr = _master_address(conf)
    fs_client = FsMasterClient(master_addr)
    worker = BlockWorker(conf, BlockMasterClient(master_addr), fs_client,
                         meta_master_client=MetaMasterClient(master_addr))
    worker.ufs_manager = WorkerUfsManager(fs_client)
    from alluxio_tpu_torch.security.authentication import (
        worker_authenticator,
    )

    server = RpcServer(bind_host="0.0.0.0",
                       port=conf.get_int(Keys.WORKER_RPC_PORT),
                       authenticator=worker_authenticator(conf))
    server.add_service(worker_service(worker))
    port = server.start()
    worker.address.rpc_port = port
    worker.address.data_port = port
    worker.start()

    def stop():
        worker.stop()
        server.stop()

    return _serve_until_signal(
        stop, f"alluxio-tpu worker serving on port {port}")


def launch_job_master(conf: Configuration) -> int:
    from alluxio_tpu_torch.job.process import JobMasterProcess

    master_addr = _master_address(conf)
    proc = JobMasterProcess(conf, master_addr)
    port = proc.start()
    return _serve_until_signal(
        proc.stop, f"alluxio-tpu job master serving on port {port}")


def launch_job_worker(conf: Configuration) -> int:
    from alluxio_tpu_torch.job.process import make_job_worker

    master_addr = _master_address(conf)
    job_master_addr = (f"{conf.get(Keys.JOB_MASTER_HOSTNAME)}:"
                       f"{conf.get_int(Keys.JOB_MASTER_RPC_PORT)}")
    jw = make_job_worker(conf, job_master_addr, master_addr,
                         socket.gethostname())
    jw.start()
    return _serve_until_signal(jw.stop, "alluxio-tpu job worker running")


def launch_proxy(conf: Configuration) -> int:
    from alluxio_tpu_torch.proxy.process import ProxyProcess

    proc = ProxyProcess(conf)
    port = proc.start()
    return _serve_until_signal(
        proc.stop, f"alluxio-tpu proxy serving on port {port}")


def launch_logserver(conf: Configuration) -> int:
    from alluxio_tpu_torch.logserver import LogServerProcess

    proc = LogServerProcess(conf.get(Keys.LOGSERVER_LOGS_DIR),
                            port=conf.get_int(Keys.LOGSERVER_PORT),
                            bind_host=conf.get(Keys.LOGSERVER_BIND_HOST))
    port = proc.start()
    return _serve_until_signal(
        proc.stop, f"alluxio-tpu log server on port {port}")


def launch_fuse(conf: Configuration) -> int:
    from alluxio_tpu_torch.client.file_system import FileSystem
    from alluxio_tpu_torch.fuse.process import (
        AlluxioFuseMount, fuse_available,
    )

    if not fuse_available():
        msg = "FUSE is unavailable (libfuse.so.2 or /dev/fuse missing)"
        LOG.warning("%s", msg)  # reaches the log server, if one is set
        print(msg)
        return 1
    fs = FileSystem(_master_address(conf), conf=conf)
    mount = AlluxioFuseMount(
        fs, conf.get(Keys.FUSE_MOUNT_POINT),
        root=conf.get(Keys.FUSE_FS_ROOT),
        options=conf.get(Keys.FUSE_MOUNT_OPTIONS))
    mount.mount()

    def stop() -> None:
        mount.unmount()
        fs.close()

    return _serve_until_signal(
        stop, f"alluxio-tpu fuse mounted at {mount.mountpoint}")


def maybe_enable_remote_logging(conf: Configuration) -> None:
    """Every role calls this: ships records to the log server when
    atpu.logserver.hostname is configured."""
    host = conf.get(Keys.LOGSERVER_HOSTNAME)
    if host:
        from alluxio_tpu_torch.logserver import enable_remote_logging

        enable_remote_logging(host, conf.get_int(Keys.LOGSERVER_PORT))


_LAUNCHERS = {
    "master": launch_master,
    "worker": launch_worker,
    "job-master": launch_job_master,
    "job-worker": launch_job_worker,
    "proxy": launch_proxy,
    "logserver": launch_logserver,
    "fuse": launch_fuse,
}


def launch_process(role: str, conf: Configuration) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    if role != "logserver":
        maybe_enable_remote_logging(conf)
    return _LAUNCHERS[role](conf)
