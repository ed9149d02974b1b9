"""``python -m alluxio_tpu_torch.yarn`` — submit/status/kill an
alluxio-tpu cluster on YARN (reference ``integration/yarn/bin`` +
``Client.java:173`` main); a copy of ``alluxio_tpu/yarn/__main__.py``
whose AM command names ``alluxio_tpu_torch.yarn.am``."""

from __future__ import annotations

import argparse
import shlex
import sys

from alluxio_tpu_torch.yarn.client import YarnRestClient


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="alluxio-tpu-yarn")
    ap.add_argument("--rm", required=True,
                    help="ResourceManager endpoint, e.g. "
                         "http://rm-host:8088")
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("submit", help="submit a cluster application")
    s.add_argument("--name", default="alluxio-tpu")
    s.add_argument("--workers", type=int, default=1)
    s.add_argument("--master-host", default=None)
    s.add_argument("--max-workers-per-host", type=int, default=1)
    s.add_argument("--am-memory-mb", type=int, default=1024)
    s.add_argument("--queue", default="default")
    s.add_argument("-C", "--conf", action="append", default=[],
                   metavar="key=value")
    for name in ("status", "kill"):
        p = sub.add_parser(name)
        p.add_argument("app_id")
    args = ap.parse_args(argv)

    cli = YarnRestClient(args.rm)
    if args.cmd == "status":
        print(cli.state(args.app_id))
        return 0
    if args.cmd == "kill":
        cli.kill(args.app_id)
        print(f"{args.app_id} kill requested")
        return 0

    am_cmd = ["python", "-m", "alluxio_tpu_torch.yarn.am",
              "--rm", args.rm, "--workers", str(args.workers),
              "--max-workers-per-host",
              str(args.max_workers_per_host)]
    if args.master_host:
        am_cmd += ["--master-host", args.master_host]
    for kv in args.conf:
        am_cmd += ["-C", kv]
    app_id = cli.new_application()
    cli.submit(app_id, args.name,
               " ".join(shlex.quote(a) for a in am_cmd),
               memory_mb=args.am_memory_mb, queue=args.queue)
    print(app_id)
    return 0


if __name__ == "__main__":
    sys.exit(main())
