"""JobShell: ``alluxio-tpu job <command>``.

A copy of ``alluxio_tpu/shell/job_shell.py``.

Re-design of ``shell/src/main/java/alluxio/cli/job/JobShell.java`` +
``job/command/*``: list/inspect/cancel jobs against the job master.
"""

from __future__ import annotations

import sys
import time

from alluxio_tpu_torch.shell.command import Command, Shell

JOB_SHELL = Shell("job", "Interact with the job service.")


def _fmt_job(info) -> str:
    when = time.strftime("%m-%d-%Y %H:%M:%S",
                         time.localtime(info.last_updated_ms / 1000))
    return (f"{info.job_id:<8d} {info.name:<12s} "
            f"{info.status:<10s} {when}"
            + (f"  {info.error_message}" if info.error_message else ""))


@JOB_SHELL.register
class LsCommand(Command):
    name, description = "ls", "List jobs known to the job master."

    def run(self, args, ctx):
        for info in ctx.job_client().list_jobs():
            ctx.print(_fmt_job(info))
        return 0


@JOB_SHELL.register
class StatCommand(Command):
    name, description = "stat", "Show one job's status (and task detail)."

    def configure(self, p):
        p.add_argument("-v", action="store_true", dest="verbose")
        p.add_argument("job_id", type=int)

    def run(self, args, ctx):
        info = ctx.job_client().get_status(args.job_id)
        ctx.print(f"ID: {info.job_id}")
        ctx.print(f"Name: {info.name}")
        ctx.print(f"Status: {info.status}")
        if info.error_message:
            ctx.print(f"Error: {info.error_message}")
        if args.verbose:
            for t in info.tasks:
                ctx.print(f"  task {t.task_id} on worker {t.worker_id}: "
                          f"{t.status}"
                          + (f" ({t.error_message})" if t.error_message
                             else ""))
        return 0


@JOB_SHELL.register
class CancelCommand(Command):
    name, description = "cancel", "Cancel a running job."

    def configure(self, p):
        p.add_argument("job_id", type=int)

    def run(self, args, ctx):
        ctx.job_client().cancel(args.job_id)
        ctx.print(f"Job {args.job_id} canceled")
        return 0


@JOB_SHELL.register
class LeaderCommand(Command):
    name, description = "leader", "Print the job master address."

    def run(self, args, ctx):
        ctx.job_client().list_plan_types()  # verifies it is serving
        ctx.print(ctx.job_master_address)
        return 0


def main(argv=None) -> int:
    return JOB_SHELL.run(sys.argv[1:] if argv is None else argv)
