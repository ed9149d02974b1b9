"""The flagship model the data plane feeds, its train step and its
checkpoints (the port of ``alluxio_tpu/models``).

The package re-exports the JAX package's names that have a counterpart
(``init_params`` has none: the port's model is the ``Transformer``
module, built from a seeded ``torch.Generator``), each loaded on first
use (PEP 562), so importing the package loads no torch.
"""

_LAZY = {
    "TransformerConfig": "alluxio_tpu_torch.models.transformer",
    "forward": "alluxio_tpu_torch.models.transformer",
    "images_to_tokens": "alluxio_tpu_torch.models.transformer",
    "loss_fn": "alluxio_tpu_torch.models.transformer",
    "param_shardings": "alluxio_tpu_torch.models.transformer",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
