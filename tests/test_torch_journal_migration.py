"""The port's offline journal migration against the JAX package's, on the
CPU (``journal/migrate.py``; the scenarios of
``tests/test_journal_migration.py``).

- ``local_to_embedded`` of the same LOCAL journal writes byte-equal
  member directories (snapshot, ``log.bin``, ``meta.bin``, ``VERSION``)
  in both packages, with and without a checkpoint; ``embedded_to_local``
  of the same quorum writes a byte-equal LOCAL journal.
- A quorum of either package boots from the other package's migration
  and applies the migrated state; after a write and a leader kill, the
  quorum's state goes back to a LOCAL journal that either package's
  journal replays.
- Both packages refuse an existing quorum, a non-empty destination and
  an unknown layout version alike.
"""

import os

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from tests.testutils.torch_ha import (  # noqa: E402
    PACKAGES, free_ports, kv_component, leader_of, mod, stop_all,
    wait_for, with_stable_leader,
)


def _local_with_data(pkg, folder, n=30, checkpoint_at=None):
    j = mod(pkg, "journal.system").LocalJournalSystem(folder)
    j.register(kv_component(pkg))
    j.start()
    j.gain_primacy()
    for i in range(n):
        with j.create_context() as ctx:
            ctx.append("kv_put", {"k": f"k{i}", "v": i})
        if checkpoint_at is not None and i == checkpoint_at:
            j.checkpoint()
    j.stop()
    return {f"k{i}": i for i in range(n)}


def _tree(folder):
    out = {}
    for root, _dirs, files in os.walk(folder):
        for name in files:
            p = os.path.join(root, name)
            with open(p, "rb") as f:
                out[os.path.relpath(p, folder)] = f.read()
    return out


@pytest.mark.parametrize("checkpoint_at", [None, 15])
def test_migrations_are_byte_equal_across_packages(tmp_path, checkpoint_at):
    addrs = ["127.0.0.1:5001", "127.0.0.1:5002", "127.0.0.1:5003"]
    # the same LOCAL journal (written by the JAX package) into both
    local = str(tmp_path / "local")
    _local_with_data(PACKAGES[0], local, 30, checkpoint_at)
    ups, downs = [], []
    for pkg in PACKAGES:
        migrate = mod(pkg, "journal.migrate")
        raft = str(tmp_path / pkg / "raft")
        ups.append((migrate.local_to_embedded(local, raft, addrs),
                    _tree(raft)))
        back = str(tmp_path / pkg / "back")
        downs.append((migrate.embedded_to_local(raft, back),
                      _tree(back)))
    assert ups[0] == ups[1] and downs[0] == downs[1]
    assert sorted(mod(PACKAGES[1], "journal.migrate").members_of(
        str(tmp_path / PACKAGES[1] / "raft"))) == addrs


def _quorum(pkg, raft_dir, ports):
    raft = mod(pkg, "journal.raft")
    addrs = [f"127.0.0.1:{p}" for p in ports]
    systems, kvs = [], []
    for a in addrs:
        j = raft.EmbeddedJournalSystem(
            raft_dir, node_id=a, address=a, addresses=",".join(addrs),
            election_timeout_ms=(300, 600), heartbeat_interval_ms=100)
        kv = kv_component(pkg)
        j.register(kv)
        systems.append(j)
        kvs.append(kv)
    return systems, kvs


@pytest.mark.parametrize("migrator,runner", [PACKAGES, PACKAGES[::-1]],
                         ids=["jax-migrates-port-runs",
                              "port-migrates-jax-runs"])
def test_round_trip_through_the_other_package(tmp_path, migrator, runner):
    local = str(tmp_path / "local")
    expect = _local_with_data(runner, local, 20, checkpoint_at=10)
    raft_dir = str(tmp_path / "raft")
    ports = free_ports(3)
    mod(migrator, "journal.migrate").local_to_embedded(
        local, raft_dir, [f"127.0.0.1:{p}" for p in ports])
    systems, kvs = _quorum(runner, raft_dir, ports)
    try:
        for j in systems:
            j.standby_start()
        wait_for(lambda: leader_of(systems) is not None, timeout=60,
                 msg="first election after migration")
        for kv in kvs:
            wait_for(lambda kv=kv: kv.data == expect, timeout=60,
                     msg="migrated state applied")

        def write(leader):
            with leader.create_context() as ctx:
                ctx.append("kv_put", {"k": "extra", "v": 7})

        with_stable_leader(systems, write)
        for kv in kvs:
            wait_for(lambda kv=kv: kv.data.get("extra") == 7,
                     msg="write replicated")
    finally:
        stop_all(systems)
    back = str(tmp_path / "back")
    out = mod(migrator, "journal.migrate").embedded_to_local(raft_dir, back)
    assert out["source_member"] in [f"127.0.0.1:{p}" for p in ports]
    for pkg in PACKAGES:
        j2 = mod(pkg, "journal.system").LocalJournalSystem(back)
        kv2 = kv_component(pkg)
        j2.register(kv2)
        j2.start()
        j2.gain_primacy()
        j2.stop()
        assert kv2.data == {**expect, "extra": 7}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_refusals_alike(tmp_path, pkg):
    migrate = mod(pkg, "journal.migrate")
    local = str(tmp_path / "local")
    _local_with_data(pkg, local, 3)
    raft_dir = str(tmp_path / "raft")
    migrate.local_to_embedded(local, raft_dir, ["127.0.0.1:9"])
    with pytest.raises(migrate.MigrationError, match="refusing"):
        migrate.local_to_embedded(local, raft_dir, ["127.0.0.1:9"])
    with pytest.raises(migrate.MigrationError, match="refusing"):
        migrate.embedded_to_local(raft_dir, local)
    with open(os.path.join(local, "VERSION"), "w") as f:
        f.write("999\n")
    with pytest.raises(migrate.MigrationError, match="v999"):
        migrate.local_to_embedded(local, str(tmp_path / "r2"),
                                  ["127.0.0.1:1"])
