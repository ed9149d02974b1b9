"""TableShell: ``alluxio-tpu table <command>``.

A copy of ``alluxio_tpu/shell/table_shell.py``.

Re-design of ``table/shell/src/main/java/alluxio/cli/table/TableShell.java``
+ ``command/{AttachDatabaseCommand,DetachDatabaseCommand,ListDbCommand,
SyncDatabaseCommand,TransformTableCommand,TransformStatusCommand}.java``:
the human entry point to the catalog service.
"""

from __future__ import annotations

from alluxio_tpu_torch.shell.command import Command, Shell

TABLE_SHELL = Shell("table", "Interact with the table (catalog) service.")


@TABLE_SHELL.register
class AttachDbCommand(Command):
    name = "attachdb"
    description = ("Attach an under-database to the catalog "
                   "(e.g. attachdb fs /warehouse/sales).")

    def configure(self, p):
        p.add_argument("udb_type",
                       help="under-database type ('fs' or 'hive')")
        p.add_argument("connection",
                       help="UDB connection (namespace path for 'fs', "
                            "thrift://host:port for 'hive')")
        p.add_argument("--db", default="",
                       help="catalog database name (default: derived; "
                            "required for hive)")
        p.add_argument("-o", "--option", action="append", default=[],
                       metavar="K=V",
                       help="UDB option (e.g. "
                            "path_translations=hdfs://nn/w=/mnt/w)")

    def run(self, args, ctx):
        options = {}
        for kv in args.option:
            k, _, v = kv.partition("=")
            options[k] = v
        name = ctx.table_client().attach_database(
            args.udb_type, args.connection, args.db, options=options)
        ctx.print(f"Attached database {name}")
        return 0


@TABLE_SHELL.register
class DetachDbCommand(Command):
    name, description = "detachdb", "Detach a database from the catalog."

    def configure(self, p):
        p.add_argument("db")

    def run(self, args, ctx):
        ctx.table_client().detach_database(args.db)
        ctx.print(f"Detached database {args.db}")
        return 0


@TABLE_SHELL.register
class LsCommand(Command):
    name = "ls"
    description = ("List databases; 'ls <db>' lists its tables; "
                   "'ls <db> <table>' shows schema + partitions.")

    def configure(self, p):
        p.add_argument("db", nargs="?")
        p.add_argument("table", nargs="?")

    def run(self, args, ctx):
        client = ctx.table_client()
        if args.db is None:
            for db in client.get_all_databases():
                ctx.print(db)
            return 0
        if args.table is None:
            for t in client.get_all_tables(args.db):
                ctx.print(t)
            return 0
        t = client.get_table(args.db, args.table)
        ctx.print(f"table: {t['name']}")
        ctx.print(f"location: {t['location']}")
        ctx.print("schema:")
        for col in t["schema"]:
            ctx.print(f"  {col['name']}: {col['type']}")
        if t.get("partition_keys"):
            ctx.print(f"partition keys: {', '.join(t['partition_keys'])}")
        ctx.print(f"partitions ({len(t['partitions'])}):")
        for part in t["partitions"]:
            ctx.print(f"  {part['spec'] or '(unpartitioned)'} -> "
                      f"{part['location']}")
        return 0


@TABLE_SHELL.register
class SyncCommand(Command):
    name, description = "sync", "Re-snapshot a database from its UDB."

    def configure(self, p):
        p.add_argument("db")

    def run(self, args, ctx):
        n = ctx.table_client().sync_database(args.db)
        ctx.print(f"Synced database {args.db}: {n} tables")
        return 0


@TABLE_SHELL.register
class TransformCommand(Command):
    name = "transform"
    description = "Kick a transform (compact) job on a table."

    def configure(self, p):
        p.add_argument("db")
        p.add_argument("table")
        p.add_argument("-d", "--definition", default="compact")
        p.add_argument("--num-files", type=int, default=1,
                       help="compacted files per partition")

    def run(self, args, ctx):
        job_id = ctx.table_client().transform_table(
            args.db, args.table, definition=args.definition,
            options={"num_files": args.num_files})
        ctx.print(f"Started transform job {job_id} on "
                  f"{args.db}.{args.table}")
        ctx.print(f"Track it with: alluxio-tpu table transformStatus "
                  f"{job_id}")
        return 0


@TABLE_SHELL.register
class TransformStatusCommand(Command):
    name, description = "transformStatus", "Show a transform job's status."

    def configure(self, p):
        p.add_argument("job_id", type=int)

    def run(self, args, ctx):
        info = ctx.table_client().transform_status(args.job_id)
        ctx.print(f"job id: {info['job_id']}")
        ctx.print(f"table: {info['db']}.{info['table']}")
        ctx.print(f"definition: {info['definition']}")
        ctx.print(f"status: {info['status']}")
        ctx.print(f"layout applied: {bool(info.get('applied'))}")
        if info.get("error"):
            ctx.print(f"error: {info['error']}")
        return 0
