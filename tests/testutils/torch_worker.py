"""The port's worker in a JAX ``LocalCluster``: a port ``BlockWorker``
behind a port ``RpcServer``, registered with the cluster's master through
the JAX master clients, as ``LocalCluster._start_worker`` registers a JAX
worker. Shared by the port's worker and prefetch tests.

``lease_loader_case`` and ``shm_loader_case`` drive the port's worker
alone (an in-memory block master, no JAX) on a given device; the card
tests and the CPU tests both run them."""

import os


class PortWorker:
    def __init__(self, cluster, base: str, *, mem_bytes: int = 4 << 20,
                 heartbeat_s: float = 0.0, conf_overrides=None,
                 authenticator=None, meta_client=None) -> None:
        """``heartbeat_s`` > 0 starts the worker's heartbeats at that
        interval; 0 registers it only (tests then tick it by hand).
        ``conf_overrides``: port keys set on the worker's conf;
        ``authenticator`` goes to the port's ``RpcServer``;
        ``meta_client`` is the worker's metrics-heartbeat target."""
        from alluxio_tpu.rpc.clients import BlockMasterClient, FsMasterClient
        from alluxio_tpu_torch.conf import Configuration, Keys
        from alluxio_tpu_torch.rpc.core import RpcServer
        from alluxio_tpu_torch.rpc.worker_service import worker_service
        from alluxio_tpu_torch.utils.wire import (TieredIdentity,
                                                  WorkerNetAddress)
        from alluxio_tpu_torch.worker.process import BlockWorker
        from alluxio_tpu_torch.worker.ufs_manager import WorkerUfsManager

        wdir = os.path.join(base, "port-worker")
        conf = Configuration(load_env=False)
        conf.set(Keys.WORKER_DATA_FOLDER, wdir)
        conf.set(Keys.WORKER_SHM_DIR, os.path.join(wdir, "shm"))
        conf.set(Keys.WORKER_RAMDISK_SIZE, mem_bytes)
        conf.set(Keys.WORKER_HOSTNAME, "localhost")
        if heartbeat_s > 0:
            conf.set(Keys.WORKER_BLOCK_HEARTBEAT_INTERVAL,
                     f"{int(heartbeat_s * 1000)}ms")
        for k, v in (conf_overrides or {}).items():
            conf.set(k, v)
        self.conf = conf
        address = WorkerNetAddress(
            host="localhost", rpc_port=0,
            shm_dir=os.path.join(wdir, "shm"),
            tiered_identity=TieredIdentity.from_spec(
                "host=localhost-port,slice=slice0"))
        fs_client = FsMasterClient(cluster.master.address)
        self.worker = BlockWorker(
            conf, BlockMasterClient(cluster.master.address), fs_client,
            ufs_manager=WorkerUfsManager(fs_client), address=address,
            meta_master_client=meta_client)
        self.server = RpcServer(bind_host="127.0.0.1", port=0,
                                authenticator=authenticator)
        self.server.add_service(worker_service(self.worker))
        self.port = self.server.start()
        address.rpc_port = address.data_port = self.port
        if heartbeat_s > 0:
            self.worker.start()
        else:
            self.worker.register_with_master()

    def stop(self) -> None:
        self.server.stop()
        self.worker.stop()


class StandInMaster:
    """The block-master calls a worker makes, answered in memory."""

    def __init__(self):
        self.commits = []

    def get_worker_id(self, address):
        return 1

    def register(self, *args):
        pass

    def heartbeat(self, *args):
        return {"command": "NOTHING", "data": []}

    def commit_block(self, worker_id, used, tier, block_id, length):
        self.commits.append(block_id)


def lease_loader_case(tmp_path, device, n=3, words=1 << 20):
    """Blocks written through ``LocalBlockOutStream`` into the port's
    worker, read into the loader on ``device`` through short-circuit
    leases: each device block equals its file, and every host -> device
    copy finds its block's lease held until the staging copy is done."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from alluxio_tpu_torch.client import torch_io
    from alluxio_tpu_torch.client.block_streams import (LocalBlockInStream,
                                                        LocalBlockOutStream)
    from alluxio_tpu_torch.conf import Configuration, Keys, Templates
    from alluxio_tpu_torch.rpc.clients import WorkerClient
    from alluxio_tpu_torch.rpc.core import RpcServer
    from alluxio_tpu_torch.rpc.worker_service import worker_service
    from alluxio_tpu_torch.utils import ids
    from alluxio_tpu_torch.worker.process import BlockWorker

    conf = Configuration(load_env=False)
    conf.set(Keys.WORKER_TIERED_STORE_LEVELS, 1)
    conf.set(Templates.WORKER_TIER_DIRS_PATH.format(0), str(tmp_path / "mem"))
    conf.set(Templates.WORKER_TIER_DIRS_QUOTA.format(0),
             str(2 * n * words * 4))
    master = StandInMaster()
    worker = BlockWorker(conf, master)
    server = RpcServer(bind_host="127.0.0.1", port=0)
    server.add_service(worker_service(worker))
    worker.address.rpc_port = server.start()
    worker.register_with_master()
    client = WorkerClient(f"127.0.0.1:{worker.address.rpc_port}")
    session = ids.create_session_id()
    files, held = {}, []
    try:
        for i in range(n):
            bid = ids.block_id(i + 1, 0)
            data = np.random.default_rng(300 + i).integers(
                -2**31, 2**31 - 1, size=words, dtype=np.int32)
            with LocalBlockOutStream(client, session, bid,
                                     size_hint=data.nbytes) as out:
                out.write(data)
            files[f"/w{i}"] = (bid, data)
        assert sorted(master.commits) == sorted(b for b, _ in files.values())

        class Source:
            def get_status(self, p):
                return SimpleNamespace(file_id=files[p][0] >> 24,
                                       block_ids=[files[p][0]])

            def open_file(self, p, info=None, max_open_streams=1):
                stream = LocalBlockInStream(client, session, files[p][0])
                return SimpleNamespace(block_stream=lambda i: stream,
                                       close=stream.close)

        copy = torch_io.host_to_device

        def watched(host, dev):
            # the lease's read lock is held across the staging copy
            before = worker.store.active_locks()
            out = copy(host, dev)
            held.append((len(held), before, worker.store.active_locks()))
            return out

        torch_io.host_to_device = watched
        loader = torch_io.DeviceBlockLoader(Source(), list(files),
                                            device=device,
                                            hbm_bytes=2 * n * words * 4,
                                            dtype=np.int32)
        try:
            blocks = list(loader.epoch())
            for block, (_, data) in zip(blocks, files.values()):
                assert block.device.type == torch.device(device).type
                assert torch.equal(block.cpu(), torch.from_numpy(data))
            assert worker.store.active_locks() == n
        finally:
            loader.close()
            torch_io.host_to_device = copy
        # the i-th copy (in file order) finds at least its own block's
        # lease and those before it held, before and after it
        assert len(held) == n
        assert all(a > i and b > i for i, a, b in held)
        assert worker.store.active_locks() == 0
    finally:
        server.stop()
        worker.stop()


def shm_loader_case(tmp_path, device, n=3, words=1 << 20):
    """Blocks written through ``LocalBlockOutStream`` into the port's
    worker (its shm dir a real directory, so the client sees it on its
    host), read into the loader on ``device`` through the SHM rung of the
    port's ``BlockStoreClient``: each device block equals its file, the
    native library pre-faulted every block, the worker holds a lease and
    an SHM pin a block while the loader is open, and none after the
    loader and then the client close."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from alluxio_tpu_torch import native
    from alluxio_tpu_torch.client import torch_io
    from alluxio_tpu_torch.client.block_store import BlockStoreClient
    from alluxio_tpu_torch.client.block_streams import LocalBlockOutStream
    from alluxio_tpu_torch.conf import Configuration, Keys, Templates
    from alluxio_tpu_torch.rpc.clients import WorkerClient
    from alluxio_tpu_torch.rpc.core import RpcServer
    from alluxio_tpu_torch.rpc.worker_service import worker_service
    from alluxio_tpu_torch.utils import ids
    from alluxio_tpu_torch.utils.wire import (BlockInfo, BlockLocation,
                                              FileBlockInfo)
    from alluxio_tpu_torch.worker.process import BlockWorker

    conf = Configuration(load_env=False)
    conf.set(Keys.WORKER_TIERED_STORE_LEVELS, 1)
    conf.set(Keys.WORKER_SHM_DIR, str(tmp_path))
    conf.set(Templates.WORKER_TIER_DIRS_PATH.format(0), str(tmp_path / "mem"))
    conf.set(Templates.WORKER_TIER_DIRS_QUOTA.format(0),
             str(2 * n * words * 4))
    worker = BlockWorker(conf, StandInMaster())
    server = RpcServer(bind_host="127.0.0.1", port=0)
    server.add_service(worker_service(worker))
    worker.address.rpc_port = server.start()
    worker.register_with_master()
    client = WorkerClient(f"127.0.0.1:{worker.address.rpc_port}")
    store = BlockStoreClient(SimpleNamespace(get_worker_infos=lambda: []))
    files, rungs = {}, []
    try:
        for i in range(n):
            bid = ids.block_id(i + 1, 0)
            data = np.random.default_rng(400 + i).integers(
                -2**31, 2**31 - 1, size=words, dtype=np.int32)
            with LocalBlockOutStream(client, store.session_id, bid,
                                     size_hint=data.nbytes) as out:
                out.write(data)
            files[f"/s{i}"] = (bid, data)

        class Source:
            def get_status(self, p):
                return SimpleNamespace(file_id=files[p][0] >> 24,
                                       block_ids=[files[p][0]])

            def open_file(self, p, info=None, max_open_streams=1):
                bid, data = files[p]
                stream = store.open_block(FileBlockInfo(block_info=BlockInfo(
                    block_id=bid, length=data.nbytes,
                    locations=[BlockLocation(worker_id=1,
                                             address=worker.address)])))
                rungs.append(stream.rung)
                return SimpleNamespace(block_stream=lambda i: stream,
                                       close=stream.close)

        native.reset_counts()
        loader = torch_io.DeviceBlockLoader(Source(), list(files),
                                            device=device,
                                            hbm_bytes=2 * n * words * 4,
                                            dtype=np.int32)
        try:
            blocks = list(loader.epoch())
            for block, (_, data) in zip(blocks, files.values()):
                assert block.device.type == torch.device(device).type
                assert torch.equal(block.cpu(), torch.from_numpy(data))
            assert rungs == ["shm"] * n
            assert worker.shm_store.stats()["live_leases"] == n
            assert len(worker.store.shm_leased_blocks) == n
        finally:
            loader.close()
            store.close()
        assert native.loaded()
        assert native.plain_calls() == {"prefault": 0, "plan": 0, "scan": 0,
                                        "crc": 0}
        assert worker.shm_store.stats()["live_leases"] == 0
        assert not worker.store.shm_leased_blocks
    finally:
        server.stop()
        worker.stop()


def cold_fetch_loader_case(tmp_path, device, n=3, words=1 << 20,
                           stripe_bytes=1 << 20):
    """Block files no worker holds, read through the UFS rung of the
    port's ``BlockStoreClient`` (the worker's striped fetch, stripes of
    ``stripe_bytes``, streamed as they land and cached as they stream)
    into the loader's device tier on ``device``, then scanned by
    ``scaled_sum``: each device block equals its file, the worker read
    each block from the UFS once and cached it, and the chained scan
    equals the plain version's on the same tensor. Returns the scan."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from alluxio_tpu_torch.client import torch_io
    from alluxio_tpu_torch.client.block_store import BlockStoreClient
    from alluxio_tpu_torch.conf import Configuration, Keys, Templates
    from alluxio_tpu_torch.metrics import metrics
    from alluxio_tpu_torch.ops import reduce_kernel as rk
    from alluxio_tpu_torch.rpc.core import RpcServer
    from alluxio_tpu_torch.rpc.worker_service import worker_service
    from alluxio_tpu_torch.underfs.registry import UfsManager
    from alluxio_tpu_torch.utils import ids
    from alluxio_tpu_torch.utils.wire import (BlockInfo, FileBlockInfo,
                                              WorkerInfo)
    from alluxio_tpu_torch.worker.process import BlockWorker

    ufs_dir = tmp_path / "ufs"
    ufs_dir.mkdir()
    conf = Configuration(load_env=False)
    conf.set(Keys.WORKER_TIERED_STORE_LEVELS, 1)
    conf.set(Templates.WORKER_TIER_DIRS_PATH.format(0), str(tmp_path / "mem"))
    conf.set(Templates.WORKER_TIER_DIRS_QUOTA.format(0),
             str(2 * n * words * 4))
    conf.set(Keys.WORKER_UFS_FETCH_STRIPE_SIZE, stripe_bytes)
    ufs = UfsManager()
    ufs.add_mount(1, str(ufs_dir))
    worker = BlockWorker(conf, StandInMaster(), ufs_manager=ufs)
    server = RpcServer(bind_host="127.0.0.1", port=0)
    server.add_service(worker_service(worker))
    worker.address.rpc_port = server.start()
    worker.register_with_master()
    master = SimpleNamespace(get_worker_infos=lambda: [WorkerInfo(
        id=1, address=worker.address, capacity_bytes=1 << 40)])
    store = BlockStoreClient(master, passive_cache=False)
    m = metrics()
    reads0 = m.counter("Worker.UfsBlocksRead").count
    started0 = m.counter("Worker.UfsFetchStarted").count
    files, rungs = {}, []
    try:
        for i in range(n):
            data = np.random.default_rng(500 + i).integers(
                -2**31, 2**31 - 1, size=words, dtype=np.int32)
            data.tofile(ufs_dir / f"c{i}")
            files[f"/c{i}"] = (ids.block_id(i + 1, 0), data)

        class Source:
            def get_status(self, p):
                return SimpleNamespace(file_id=files[p][0] >> 24,
                                       block_ids=[files[p][0]])

            def open_file(self, p, info=None, max_open_streams=1):
                bid, data = files[p]
                stream = store.open_block(
                    FileBlockInfo(block_info=BlockInfo(
                        block_id=bid, length=data.nbytes)),
                    ufs_info={"ufs_path": str(ufs_dir / p[1:]),
                              "offset": 0, "length": data.nbytes,
                              "mount_id": 1})
                rungs.append(stream.rung)
                return SimpleNamespace(block_stream=lambda i: stream,
                                       close=stream.close)

        loader = torch_io.DeviceBlockLoader(Source(), list(files),
                                            device=device,
                                            hbm_bytes=2 * n * words * 4,
                                            dtype=np.int32)
        try:
            blocks = list(loader.epoch())
            for block, (_, data) in zip(blocks, files.values()):
                assert block.device.type == torch.device(device).type
                assert torch.equal(block.cpu(), torch.from_numpy(data))
            x = torch.cat(blocks)
            acc = rk.scaled_sum(x, 3)
            assert int(acc) == int(rk.scaled_sum_reference(x, 3))
        finally:
            loader.close()
        assert rungs == ["ufs"] * n
        assert m.counter("Worker.UfsBlocksRead").count - reads0 == n
        assert m.counter("Worker.UfsFetchStarted").count - started0 == n
        assert all(worker.store.has_block(b) for b, _ in files.values())
        return int(acc)
    finally:
        store.close()
        server.stop()
        worker.stop()
