"""The parallel layer: the port of ``alluxio_tpu/parallel``.

The mesh on ``torch.distributed`` (``mesh.py``), the tensor-parallel
autograd Functions (``tensor_parallel.py``), the mesh data plane
(``ici_store.py``), attention and ring attention
(``ring_attention.py``), the mixture-of-experts FFN (``moe.py``) and the
pipeline (``pipeline.py``).
"""
