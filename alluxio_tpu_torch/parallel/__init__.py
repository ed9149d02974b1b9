"""The parallel layer: the port of ``alluxio_tpu/parallel``.

The mesh on ``torch.distributed`` (``mesh.py``), the tensor-parallel
autograd Functions (``tensor_parallel.py``), the mesh data plane
(``ici_store.py``), attention and ring attention
(``ring_attention.py``), the mixture-of-experts FFN (``moe.py``) and the
pipeline (``pipeline.py``).

The package re-exports the JAX package's names that have a counterpart
(JAX's ``named_sharding`` and ``replicated`` build ``NamedSharding``s;
the port's layouts are ``mesh.layout`` and ``mesh.REPLICATED``), each
loaded on first use (PEP 562), so importing the package loads no torch.
As in JAX, the package's ``ring_attention`` is the FUNCTION, not the
submodule of the same name: import the submodule with
``importlib.import_module("alluxio_tpu_torch.parallel.ring_attention")``
or ``from alluxio_tpu_torch.parallel.ring_attention import ...``.
"""

import sys
import types

_LAZY = {
    "DATA_AXIS": "alluxio_tpu_torch.parallel.mesh",
    "MODEL_AXIS": "alluxio_tpu_torch.parallel.mesh",
    "make_mesh": "alluxio_tpu_torch.parallel.mesh",
    "shard_host_batch": "alluxio_tpu_torch.parallel.mesh",
    "reference_attention": "alluxio_tpu_torch.parallel.ring_attention",
    "ring_attention": "alluxio_tpu_torch.parallel.ring_attention",
}


class _Package(types.ModuleType):
    """Keeps the name ``ring_attention`` bound to the function: the
    import system binds each submodule on its package once it has
    loaded, and JAX's package, which imports the function eagerly, keeps
    the function there."""

    def __setattr__(self, name, value):
        if name == "ring_attention" and isinstance(value, types.ModuleType):
            value = value.ring_attention
        super().__setattr__(name, value)


sys.modules[__name__].__class__ = _Package


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
