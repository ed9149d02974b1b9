"""Command-line entry points (a subset of ``alluxio_tpu/shell``).

``python -m alluxio_tpu_torch.shell.main <role>`` runs one of the four
role processes (master, worker, job master, job worker) in the
foreground until SIGINT or SIGTERM; ``shell/launch.py`` builds them from
the configuration (``ATPU_*`` variables and ``-D key=value``). The JAX
package's interactive shells and its other launchers are not ported
yet: ``main`` says which ROADMAP item brings each.
"""
