"""atpu-lint for the PyTorch port: the repo-native static analyzers.

The port of ``alluxio_tpu/lint/``. The port's three load-bearing
registries — ``atpu.*`` conf keys, instance-prefixed metric/span names
and trace phases, and the typed wire-error map — rot without a machine
check: a typo'd metric name makes a health rule permanently blind, and
a cataloged phase that nothing emits makes a traced read attribute less
of its critical path, both with zero test failures.

Six AST-based analyzers, run as ``python -m alluxio_tpu_torch.lint``
(exit 0 clean, 1 findings, 2 over the 30 s budget or a bad invocation):

- ``conf-keys``       every ``atpu.*`` literal resolves to a registered
                      ``PropertyKey`` (or span name), every registered
                      key is read somewhere, defaults parse under their
                      declared types
- ``metric-names``    emitters + consumers (health rules, benches,
                      shell) form one registry; near-miss typos and
                      exposition-hostile names are flagged
- ``phase-names``     every ``Span.phase`` emit names a member of
                      ``utils/tracing.py``'s ``PHASES`` and every member
                      has an emit site
- ``lock-discipline`` blocking calls (RPC, UFS I/O, ``time.sleep``,
                      unbounded ``.result()``/``.wait()``) made while
                      holding a lock
- ``exceptions``      ``except Exception`` on server dispatch /
                      heartbeat / QoS paths that neither logs nor
                      re-raises, and wire-error classes outside the
                      serialization map
- ``native-abi``      the ctypes prototypes against the ``atpu_*``
                      symbols the compiled native library exports

It scans ``alluxio_tpu_torch/`` only and reads no docs: the JAX
package's doc rules and doc writer are left out. Each analyzer honors
inline suppressions (``# lint: allow[rule] -- justification``) and a
checked-in baseline (``alluxio_tpu_torch/lint/baseline.json``) that
freezes known findings; new findings fail the run. The companion pytest
plugin (``alluxio_tpu_torch.lint.pytest_lockaudit``) is the dynamic
half: it instruments the port's master/worker/store locks with
``utils.race.LockOrderAuditor`` in every port test and fails a test on
any observed lock-order inversion.
"""

from alluxio_tpu_torch.lint.findings import Finding, Suppression  # noqa: F401
from alluxio_tpu_torch.lint.runner import LintReport, run_lint  # noqa: F401
