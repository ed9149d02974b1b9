# Developer entry points (packaging analogue of the reference's
# build/ + assembly tooling).

PY ?= python

.PHONY: test test-fast native bench bench-prefetch bench-obs bench-smallread bench-table bench-health bench-selfheal bench-ufs-cold bench-remote-read bench-qos bench-metadata bench-ha sdist clean lint lint-changed lint-docs

lint:  ## atpu-lint: conf-key/metric-name/lock/exception discipline (<30s budget)
	$(PY) -m alluxio_tpu.lint --budget-s 30

lint-changed:  ## fast mode: only files changed vs HEAD (registry-wide rules skipped)
	$(PY) -m alluxio_tpu.lint --changed

lint-docs:  ## regenerate docs/configuration.md + docs/metrics.md from the registries
	$(PY) -m alluxio_tpu.lint --write-docs

test: lint
	@$(PY) -c "import alluxio_tpu.native as n; n.lib() is None and print('native layer unavailable (no g++?): running pure-Python fallback paths only')"
	$(PY) -m pytest tests/ -q

test-fast:  ## skip multi-process (subprocess-spawning) tests
	@$(PY) -c "import alluxio_tpu.native as n; n.lib() is None and print('native layer unavailable (no g++?): running pure-Python fallback paths only')"
	$(PY) -m pytest tests/ -q -m "not slow"

native:  ## force-rebuild the C++ layer (-Wall -Werror)
	rm -f alluxio_tpu/native/_libatpu_native.so
	$(PY) -c "import alluxio_tpu.native as n; assert n.lib() is not None"

.PHONY: lint-torch test-torch native-torch

lint-torch:  ## the PyTorch port's lint over alluxio_tpu_torch/ (<30s budget)
	$(PY) -m alluxio_tpu_torch.lint --budget-s 30

test-torch:  ## the PyTorch port's CPU tests (tests/test_torch_*.py against the JAX package), skipping multi-process tests
	@$(PY) -c "import alluxio_tpu_torch.native as n; n.lib() is None and print('native layer unavailable (no g++?): running pure-Python fallback paths only')"
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_torch_*.py -q -m "not slow"

native-torch:  ## force-rebuild the PyTorch port's C++ layer (build/torch_native/)
	rm -rf build/torch_native
	$(PY) -c "import alluxio_tpu_torch.native as n; assert n.lib() is not None"

bench:
	$(PY) bench.py

bench-prefetch:  ## clairvoyant prefetch: hit-rate + p50/p99 block-ready lateness
	JAX_PLATFORMS=cpu $(PY) -m alluxio_tpu.stress prefetch --clairvoyant \
		--num-workers 1 --num-files 4 --file-mb 8 --epochs 2

bench-obs:  ## observability gates: tracing + profiler overhead (<2% budget), critical-path attribution (>=90%)
	JAX_PLATFORMS=cpu $(PY) -m alluxio_tpu.stress obs
	JAX_PLATFORMS=cpu $(PY) -m alluxio_tpu.stress obs --row profile
	JAX_PLATFORMS=cpu $(PY) -m alluxio_tpu.stress obs --row critical-path --file-mb 2 --reads 80

bench-smallread:  ## small-read plane: read_many coalescing (>=3x per-op ops/s), SHM zero-copy fidelity (buffer identity, no wire phase), native fastpath batched scatter (>=5x pure-Python, byte-identical)
	JAX_PLATFORMS=cpu $(PY) -m alluxio_tpu.stress smallread --row batch
	JAX_PLATFORMS=cpu $(PY) -m alluxio_tpu.stress smallread --row shm
	JAX_PLATFORMS=cpu $(PY) -m alluxio_tpu.stress smallread --row native --min-speedup 5.0

bench-table:  ## table reads: projection composite (>=4x full-scan/projection) + planned-vs-legacy pushdown (>=2x, byte-identity asserted in-bench)
	JAX_PLATFORMS=cpu $(PY) -m alluxio_tpu.stress table
	JAX_PLATFORMS=cpu $(PY) -m alluxio_tpu.stress table --row pushdown

bench-health:  ## metrics-history ingestion: heartbeat hot-path overhead (<5% gate, fake clock)
	JAX_PLATFORMS=cpu $(PY) -m alluxio_tpu.stress health

bench-selfheal:  ## remediation engine: detection->action latency + health-tick overhead (<2% gate, fake clock)
	JAX_PLATFORMS=cpu $(PY) -m alluxio_tpu.stress selfheal

bench-ufs-cold:  ## cold UFS reads: striped vs single-stream GB/s + ttfb (1.5x gate at c=4)
	JAX_PLATFORMS=cpu $(PY) -m alluxio_tpu.stress ufscold

bench-remote-read:  ## warm remote reads: striped vs single-stream GB/s + hedged straggler drill (1.5x gate at 4 stripes)
	JAX_PLATFORMS=cpu $(PY) -m alluxio_tpu.stress remoteread

bench-qos:  ## two-tenant QoS: victim read p99 under flood <=2x solo with QoS on + admission bounded-memory shedding
	JAX_PLATFORMS=cpu $(PY) -m alluxio_tpu.stress qos

bench-metadata:  ## metadata control plane: striped-vs-single-lock >=3x, batched-journal CreateFile >=1.5x, cached GetStatus >=10x, hot-dir WRITE_EDGE >=2x, 10M-inode LSM capacity under a 2GB cap
	JAX_PLATFORMS=cpu $(PY) -m alluxio_tpu.stress metadata --row striped
	JAX_PLATFORMS=cpu $(PY) -m alluxio_tpu.stress metadata --row journal
	JAX_PLATFORMS=cpu $(PY) -m alluxio_tpu.stress metadata --row cached
	JAX_PLATFORMS=cpu $(PY) -m alluxio_tpu.stress metadata --row hot-dir
	JAX_PLATFORMS=cpu $(PY) -m alluxio_tpu.stress metadata --row lsm-capacity

bench-ha:  ## HA failover drill: MTTR <= 2 election timeouts, zero acked-write loss, standby staleness contract
	JAX_PLATFORMS=cpu $(PY) -m alluxio_tpu.stress ha

sdist:
	$(PY) -m build --sdist 2>/dev/null || $(PY) setup.py sdist

clean:
	rm -rf build dist *.egg-info .pytest_cache
	rm -f alluxio_tpu/native/_libatpu_native.so
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null || true
